#!/usr/bin/env python3
"""Where the time of the port's per-scan loop goes, on one NVIDIA GPU.

    python3 loop_profile.py [--root DIR] [--seed 0] [--probe] [--out DIR]

Drives the port's ``Mapper`` through the synthetic sequence of
``chip_smoke.py`` (18 scans of 49,152 rays, seed ``--seed``) in four
configs -- ``identity`` (examples/config.yaml), ``p2plane``
(examples/config_p2plane.yaml, perturbed priors), ``default``
(``Mapper(None)``, the same priors), ``p2point`` (the default with
``chip_smoke.py``'s point-to-point ``icp:`` section, the same priors) and
``p2plane_step`` (the p2plane config with ``chip_smoke.py``'s random step
filter, prob 0.9, the same priors) -- and prints one JSON line per config:

  step_locked_ms_per_scan  host clock around apply_input_filters +
                           process_input + drain(), steady scans (2-17)
  free_running_scans_per_s the same scans without drain() (one at the end)
  solve_ms_per_scan, ms_per_icp_iteration
                           the ``solve`` phase of ``PhaseTimer`` (CUDA events)
  blocking_reads_per_scan  synchronising calls that torch reports under
                           ``torch.cuda.set_sync_debug_mode("warn")`` inside
                           apply_input_filters + process_input (scans 2-5)
  profile                  ``torch.profiler`` over scans 3-5, each solve
                           between two synchronisations: device busy ms,
                           device launches and device idle share inside the
                           solves, per ICP iteration; device launches per
                           scan (all of the scans' device events)
  step_chain               (configs with step filters) device launches of
                           the step chain of one matcher pass, the first
                           of the sixth scan's solve (``_Loop._stepped``),
                           and of the sharded solve's ``_step_mask`` with
                           the same chain on the same reading sorted by the
                           sweep (``ShardedMapperStep`` without a group)
  graph_captures, mapper_waits
                           what the package counts, where it counts it

``--root DIR`` measures the package of another checkout (for instance the
parent commit unpacked beside this one); the sequence always comes from the
``chip_smoke.py`` next to this file.  ``--probe`` measures nothing of that:
it checks whether this torch and CUDA runtime capture a conditional WHILE node
(``norlab_icp_mapper_tpu_torch/csrc/graph_loop.cu``) around a captured body
that allocates, sorts, multiplies and solves, replays it against the same
body run by a Python loop, times the node alone, then holds the engine's
solve graph against its Python loop on the second scan of each config (T bit
for bit, iterations, wall ms), and stops.  The chrome traces go to
``--out``.  Without a GPU the script exits 1.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time
import warnings

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
CONFIGS = (("identity", "examples/config.yaml"),
           ("p2plane", "examples/config_p2plane.yaml"),
           ("default", None))


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def probe():
    """A WHILE node around a body that allocates, sorts, multiplies and
    solves, replayed against the same body under a Python loop."""
    from norlab_icp_mapper_tpu_torch.ops import graph_loop
    dev = torch.device("cuda")
    it = torch.zeros((), dtype=torch.int32, device=dev)
    done = torch.zeros((), dtype=torch.bool, device=dev)
    x = torch.linspace(-1.0, 1.0, 4096, device=dev)
    x0 = x.clone()
    # the commit's state: the identity increment, no checker, so the loop
    # ends when the counter runs out
    eye = torch.eye(4, device=dev)
    T, hist = eye.clone(), torch.zeros((1, 2), device=dev)
    ov_new, ov = torch.ones((), device=dev), torch.zeros((), device=dev)

    def commit(counter, flag, max_iter, wb):
        graph_loop.loop_commit(eye, T, counter, flag, hist, ov_new, ov,
                               max_iter=max_iter, body=wb)

    def body(wb=None):
        y = torch.sort(torch.sin(x * 3.0)).values
        m = y[:36].view(6, 6)
        a = m @ m.T + 6.0 * torch.eye(6, device=dev)
        s = torch.linalg.solve_ex(a, y[100:106]).result
        j = torch.searchsorted(y, y[2048:2050])
        step = s.sum() * 1e-3 + y.index_select(0, j[:1])[0] * 1e-4
        x.copy_(torch.where(~done & (it < 7), x + step, x))
        commit(it, done, 7, wb)  # it += active; the node's condition

    def reset():
        x.copy_(x0)
        it.zero_()
        done.zero_()

    reset()
    while not bool(done) and int(it) < 7:
        body()
    want_x, want_it = x.clone(), int(it)
    out = {"phase": "probe",
           "torch_if_node": hasattr(torch.cuda.CUDAGraph,
                                    "begin_capture_to_if_node"),
           "torch_while_node": [n for n in dir(torch.cuda.CUDAGraph)
                                if "while" in n.lower()]}
    body_stream, pool = torch.cuda.Stream(), torch.cuda.MemPool()
    capture = torch.cuda.Stream()
    graph = torch.cuda.CUDAGraph()
    # warm up on the body stream: library handles and workspaces exist
    # before the capture
    body_stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(body_stream):
        reset()
        body()
    torch.cuda.synchronize()
    with torch.cuda.stream(capture):
        graph.capture_begin(capture_error_mode="thread_local")
        try:
            reset()
            with graph_loop.while_node(it, done, 7, body_stream,
                                       pool) as wb:
                body(wb)
        finally:
            graph.capture_end()
    x.fill_(123.0)
    graph.replay()
    torch.cuda.synchronize()
    out["while_node_iterations"] = int(it)
    out["while_node_bit_identical"] = bool(torch.equal(x, want_x)) \
        and int(it) == want_it
    # the node's own cost: a body of one kernel (the commit that counts
    # and sets the condition), 1000 times
    n = torch.zeros((), dtype=torch.int32, device=dev)
    stop = torch.zeros((), dtype=torch.bool, device=dev)
    g2, pool2 = torch.cuda.CUDAGraph(), torch.cuda.MemPool()
    with torch.cuda.stream(capture):
        g2.capture_begin(capture_error_mode="thread_local")
        try:
            n.zero_()
            with graph_loop.while_node(n, stop, 1000, body_stream,
                                       pool2) as wb:
                commit(n, stop, 1000, wb)
        finally:
            g2.capture_end()
    g2.replay()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(
        enable_timing=True)
    a.record()
    g2.replay()
    b.record()
    torch.cuda.synchronize()
    out["while_node_us_per_iteration_one_kernel"] = \
        a.elapsed_time(b) * 1e3 / 1000
    out["while_node_iterations_1000"] = int(n)
    emit(out)
    return out["while_node_bit_identical"] and int(n) == 1000


def engine_check(nt, name, cfg, scans, priors, cap):
    """The solve graph against the same body under the Python loop, on the
    second scan of the sequence (the first builds the map): T bit for bit,
    iterations, and the wall time of each (five runs, synchronised)."""
    from norlab_icp_mapper_tpu_torch import se3
    from norlab_icp_mapper_tpu_torch.icp import engine
    m = make_mapper(nt, cfg)
    m.timer.enabled = False
    feed(nt, m, scans[0], priors[0], 0, cap)
    icp = m.icp
    batch = nt.PointBatch.from_numpy(scans[1], capacity=cap, device="cuda")
    reading = se3.apply(torch.as_tensor(priors[1], device="cuda"),
                        m.apply_input_filters(batch))
    if len(icp.reading_filters):
        reading = icp.reading_filters._apply_impl(reading, m.draws)
    ref = icp._ref
    args = (reading.positions, reading.mask, ref.positions,
            icp.check_reference(ref), ref.mask, icp._ref_pack)

    def graph():
        return icp.solve(*args)[:3]

    def loop():
        return engine._icp_solve(*args, **icp.solve_config())[:3]

    rec = {"phase": "engine_check", "config": name}
    outs = {}
    for label, fn in (("graph", graph), ("loop", loop)):
        outs[label] = fn()
        torch.cuda.synchronize()
        ms = []
        for _ in range(5):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        rec[f"{label}_ms"] = statistics.median(ms)
    (Tg, og, ig), (Tl, ol, il) = outs["graph"], outs["loop"]
    rec.update({"iterations_graph": int(ig), "iterations_loop": int(il),
                "T_bit_identical": bool(torch.equal(Tg, Tl)),
                "T_max_abs_diff": float((Tg - Tl).abs().max()),
                "overlap_equal": bool(torch.equal(og, ol)),
                "graph_captures": icp.graph_captures})
    m.shutdown()
    emit(rec)
    return rec["T_bit_identical"] and int(ig) == int(il)


def make_mapper(nt, cfg):
    path = (None if cfg is None else cfg if isinstance(cfg, dict)
            else os.path.join(HERE, cfg))
    m = nt.Mapper(path, is_3d=True, device="cuda", seed=0)
    m.timer.enabled = True
    return m


def feed(nt, mapper, scan, prior, i, cap):
    batch = nt.PointBatch.from_numpy(scan, capacity=cap, device="cuda")
    filtered = mapper.apply_input_filters(batch)
    mapper.process_input(filtered, prior, int(i * 1e8))


def timed_runs(nt, cfg, scans, priors, cap):
    """Step-locked and free-running drives; solve phase and iterations."""
    m = make_mapper(nt, cfg)
    per, iters = [], []
    for i, (s, p) in enumerate(zip(scans, priors)):
        m.drain()
        t0 = time.perf_counter()
        feed(nt, m, s, p, i, cap)
        m.drain()
        per.append((time.perf_counter() - t0) * 1e3)
        iters.append(int(m.last_iterations))
        if i == 1:
            m.timer.totals()  # the first two scans carry one-time set-up
    phases = m.timer.totals()
    captures = getattr(m.icp, "graph_captures", None)
    waits = dict(getattr(m, "waits", {}) or {})
    steady_it = sum(iters[2:])
    rec = {"step_locked_ms_per_scan": statistics.mean(per[2:]),
           "per_scan_ms": [round(v, 2) for v in per],
           "icp_iterations": iters,
           "solve_ms_per_scan": phases.get("solve", 0.0) / (len(scans) - 2),
           "ms_per_icp_iteration": (phases.get("solve", 0.0) / steady_it
                                    if steady_it else None),
           "final_map_count": int(m.map.known_count()),
           "graph_captures": captures, "mapper_waits": waits}
    m.shutdown()
    m = make_mapper(nt, cfg)
    m.timer.enabled = False
    for i in range(2):
        feed(nt, m, scans[i], priors[i], i, cap)
    m.drain()
    t0 = time.perf_counter()
    for i in range(2, len(scans)):
        feed(nt, m, scans[i], priors[i], i, cap)
    m.drain()
    rec["free_running_scans_per_s"] = (len(scans) - 2) / (
        time.perf_counter() - t0)
    rec["free_running_mapper_waits"] = dict(getattr(m, "waits", {}) or {})
    m.shutdown()
    return rec


def blocking_reads(nt, cfg, scans, priors, cap, n=6):
    """Synchronising calls inside the filters and the step, scans 2..n-1:
    their number per scan, and where they were made (file:line of the
    package's frame that made each, over those scans)."""
    m = make_mapper(nt, cfg)
    m.timer.enabled = False
    counts, where = [], {}
    for i in range(n):
        m.drain()
        batch = nt.PointBatch.from_numpy(scans[i], capacity=cap,
                                         device="cuda")
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                filtered = m.apply_input_filters(batch)
                m.process_input(filtered, priors[i], int(i * 1e8))
            finally:
                torch.cuda.set_sync_debug_mode(0)
        syncs = [w for w in caught if "synchroniz" in str(w.message)]
        counts.append(len(syncs))
        if i >= 2:
            for w in syncs:
                key = f"{os.path.relpath(w.filename, HERE)}:{w.lineno}"
                where[key] = where.get(key, 0) + 1
    m.drain()
    m.shutdown()
    return counts[2:], where


def solve_windows(trace_path):
    """Device busy time, launches and window length inside each
    ``icp_solve`` range of a chrome trace, in order."""
    with open(trace_path) as fh:
        ev = json.load(fh)["traceEvents"]
    # the host's range (the profiler also draws the same range on the
    # device's timeline, as "gpu_user_annotation")
    wins = sorted((e["ts"], e["ts"] + e["dur"]) for e in ev
                  if e.get("name") == "icp_solve" and e.get("ph") == "X"
                  and e.get("cat") == "user_annotation")
    dev = sorted((e["ts"], e["ts"] + e.get("dur", 0)) for e in ev
                 if e.get("ph") == "X" and e.get("cat") in (
                     "kernel", "gpu_memcpy", "gpu_memset"))
    out = []
    for a, b in wins:
        inside = [(max(s, a), min(t, b)) for s, t in dev if t > a and s < b]
        busy, end = 0.0, a
        for s, t in sorted(inside):
            s = max(s, end)
            if t > s:
                busy += t - s
                end = t
        out.append({"window_us": b - a, "busy_us": busy,
                    "launches": len(inside)})
    return out


def profile(nt, cfg, scans, priors, cap, out_dir, name):
    """torch.profiler over scans 3-5; each solve between two syncs.  A
    solve that captured a graph (a new map capacity: its eager warm-up and
    capture) is left out of the per-iteration figures and counted."""
    from torch.profiler import ProfilerActivity, profile as tprofile
    m = make_mapper(nt, cfg)
    m.timer.enabled = False
    inner = m.icp.solve
    captured = []  # per solve in order: did it capture a graph?

    def solve(*a, **k):
        before = getattr(m.icp, "graph_captures", 0)
        torch.cuda.synchronize()
        with torch.profiler.record_function("icp_solve"):
            out = inner(*a, **k)
            torch.cuda.synchronize()
        captured.append(getattr(m.icp, "graph_captures", 0) != before)
        return out
    m.icp.solve = solve
    for i in range(3):
        feed(nt, m, scans[i], priors[i], i, cap)
        m.drain()
    iters, its = 0, []
    del captured[:]
    with tprofile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        for i in range(3, 6):
            feed(nt, m, scans[i], priors[i], i, cap)
            m.drain()
            its.append(int(m.last_iterations))
    m.shutdown()
    path = os.path.join(out_dir, f"trace_{name}.json")
    prof.export_chrome_trace(path)
    w = solve_windows(path)
    launches_per_scan = device_events(path) / 3
    keep = [not c for c in captured]
    w = [x for x, k in zip(w, keep) if k]
    iters = sum(n for n, k in zip(its, keep) if k)
    busy = sum(x["busy_us"] for x in w)
    win = sum(x["window_us"] for x in w)
    return {"solves": len(w), "solves_with_a_capture_left_out":
            keep.count(False), "iterations": iters,
            "device_busy_ms_per_iteration": busy / 1e3 / max(iters, 1),
            "device_launches_per_iteration":
                sum(x["launches"] for x in w) / max(iters, 1),
            "solve_window_ms_per_iteration": win / 1e3 / max(iters, 1),
            "device_idle_share_in_solve": 1.0 - busy / win if win else None,
            "device_launches_per_scan": launches_per_scan}


def device_events(trace_path) -> int:
    """Device activities (kernels, copies, fills) in a chrome trace."""
    with open(trace_path) as fh:
        ev = json.load(fh)["traceEvents"]
    return sum(1 for e in ev if e.get("ph") == "X" and e.get("cat") in (
        "kernel", "gpu_memcpy", "gpu_memset"))


def launches_of(fn) -> int:
    """Device activities that one call of ``fn`` starts (after one
    untimed call), by ``torch.profiler``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as tprofile
    fn()
    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(1 for e in prof.events() if e.device_type == DeviceType.CUDA)


def step_chain(nt, cfg, scans, priors, cap):
    """Device launches of one matcher pass's step chain: the first pass of
    the sixth scan's solve (``_Loop`` started: T = I, ``it`` = 0), and the
    sharded solve's ``_step_mask`` with the same chain on the same reading
    sorted as its sweep sorts it (1-NN within 1 m, the reference as the
    block).  The package's own pieces, so that a checkout before a change
    and after it are measured alike."""
    from norlab_icp_mapper_tpu_torch import se3
    from norlab_icp_mapper_tpu_torch.icp import engine
    from norlab_icp_mapper_tpu_torch.parallel import sharded_map as SM
    m = make_mapper(nt, cfg)
    m.timer.enabled = False
    for i in range(5):
        feed(nt, m, scans[i], priors[i], i, cap)
        m.drain()
    icp = m.icp
    batch = nt.PointBatch.from_numpy(scans[5], capacity=cap, device="cuda")
    reading = se3.apply(torch.as_tensor(priors[5], device="cuda"),
                        m.apply_input_filters(batch))
    if len(icp.reading_filters):
        reading = icp.reading_filters._apply_impl(reading, m.draws)
    ref = icp._ref
    args = (reading.positions, reading.mask, ref.positions,
            icp.check_reference(ref), ref.mask, icp._ref_pack)
    chain = icp.reading_step_filters
    solve = torch.zeros((), dtype=torch.int64, device="cuda")
    loop = engine._Loop(*args, step_filters=chain, draws=m.draws,
                        solve_index=solve, **icp.solve_config())
    loop.start()
    p = se3.apply_points(loop.T, loop.read)
    out = {"sorted": loop.order is not None,
           "launches_per_pass": launches_of(
               lambda: loop._stepped(p, loop.mask))}
    step = SM.ShardedMapperStep.__new__(SM.ShardedMapperStep)
    step.cfg = SM.ShardedMapConfig(match_max_dist=1.0,
                                   step_filter=chain._apply_impl)
    # the matcher's reading, the order that sorted it (and, after the
    # row-order change, the inverse it builds once per solve)
    matched = step._matcher(args[0], args[1], ref.positions, ref.mask)
    draws = m.draws.keyed(solve, loop.it)
    out["sharded_launches_per_pass"] = launches_of(
        lambda: step._step_mask(matched[1], matched[2], draws,
                                *matched[3:]))
    m.shutdown()
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--probe", action="store_true")
    ap.add_argument("--out", default=os.path.join(HERE,
                                                  "loop_profile_traces"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("loop_profile: no CUDA device", file=sys.stderr)
        return 1
    os.makedirs(args.out, exist_ok=True)
    sys.path.insert(0, HERE)
    import chip_smoke as cs  # the sequence (numpy only)
    sys.path.insert(0, os.path.abspath(args.root))
    import norlab_icp_mapper_tpu_torch as nt
    from norlab_icp_mapper_tpu_torch.ops import _build
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip()
    emit({"phase": "card", "nvidia_smi": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda, "package": os.path.dirname(nt.__file__)})
    _build.start_builds()
    for name in _build.KERNEL_SOURCES:
        _build.load(name)
    scans, poses = cs.make_sequence(args.seed, cs.N_SCANS)
    rng = np.random.default_rng(args.seed + 1)
    perturbed = [poses[0]] + [cs.perturb(p, rng) for p in poses[1:]]
    if args.probe:
        ok = probe()
        for name, cfg in CONFIGS:
            priors = poses if name == "identity" else perturbed
            ok = engine_check(nt, name, cfg, scans, priors,
                              cs.SCAN_CAPACITY) and ok
        print(smi, flush=True)
        return 0 if ok else 1
    recs = {}
    configs = CONFIGS + (("p2point", {"icp": cs.p2point_icp(False)}),
                         ("p2plane_step", cs.step_config()))
    for name, cfg in configs:
        priors = poses if name == "identity" else perturbed
        rec = {"phase": name, "config": cfg}
        rec.update(timed_runs(nt, cfg, scans, priors, cs.SCAN_CAPACITY))
        reads, where = blocking_reads(nt, cfg, scans, priors,
                                      cs.SCAN_CAPACITY)
        rec["blocking_reads_per_scan"] = reads
        rec["blocking_reads_where"] = where
        recs[name] = rec
    # the profiler last: its hooks slow every later launch
    for name, cfg in configs:
        if isinstance(cfg, dict) and cfg["icp"].get(
                "readingStepDataPointsFilters"):
            recs[name]["step_chain"] = step_chain(
                nt, cfg, scans, perturbed, cs.SCAN_CAPACITY)
    for name, cfg in configs:
        priors = poses if name == "identity" else perturbed
        recs[name]["profile"] = profile(nt, cfg, scans, priors,
                                        cs.SCAN_CAPACITY, args.out, name)
        emit(recs[name])
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
