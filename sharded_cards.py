#!/usr/bin/env python3
"""The sharded mapper over NCCL on the cards of one host.

    torchrun --standalone --nproc-per-node N sharded_cards.py [--seed 0]
    torchrun --standalone --nproc-per-node N sharded_cards.py --probe MODE

Every rank makes ``chip_smoke.py``'s hall sequence (18 scans of 49,152 rays)
from the seed and drives ``Mapper("examples/config_p2plane.yaml",
mesh=make_mesh())`` over it with the p2plane priors, drained after every
scan.  Rank 0 prints one JSON line (and writes it to
``chiprun_out/sharded_cards_w<N>.json``): the card's name and power limit,
the world size, steady ms per scan, the solve's ms per scan (CUDA events
around each replay of its graph), the time of one iteration's reductions
(each collective of the solve timed alone after the drive), the halo's
gathered bytes per merge, ATE, map size, each
rank's block count and capacity, the balance, rank 0's overflowing search
windows by pass (``utils.tracing``), and whether every rank ends
with the same poses, table, window and map bit for bit.  Needs one card
per rank; exits non-zero without CUDA.

``--probe unrolled|while_node`` only asks whether NCCL can run inside a
CUDA graph: five ``all_reduce(SUM)`` one after another, or as the body of
a WHILE node (``ops/graph_loop.py``), against the same collectives run
eagerly; rank 0 prints the outcome (and the exact error of a refusal) as
one JSON line.  Run it under ``timeout``: a collective that one rank
captured and another did not waits for ever.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch


PROBES = ("unrolled", "while_node")


def probe_nccl_graph(rank: int, world: int, mode: str) -> dict:
    """Five ``all_reduce(SUM)`` captured in a CUDA graph: one after another
    (``unrolled``), or as the body of a WHILE node with one increment
    (``while_node``, ``ops/graph_loop.py``).  Each rank's tensor must end
    equal to five eager reductions' result.  A refusal is recorded with the
    step that raised first and its exact error; every step is also printed
    to standard error as it starts, so that a hang shows where it stopped
    (run each mode under ``timeout``)."""
    import torch.distributed as dist
    from norlab_icp_mapper_tpu_torch.ops import graph_loop
    dev = torch.device("cuda")
    n_iter = 5
    x = torch.ones(4096, device=dev)
    eager = torch.ones(4096, device=dev)
    side = torch.cuda.Stream()
    # the communicator, and the collective on the capturing stream, exist
    # before the capture
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        dist.all_reduce(x)
        for _ in range(n_iter):
            dist.all_reduce(eager)
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    rec = {"probe": mode, "world_size": world,
           "nccl_version": ".".join(map(str, torch.cuda.nccl.version())),
           "cuda": torch.version.cuda, "torch": torch.__version__}
    stage = []

    def step(name):
        stage.append(name)
        print(f"probe rank {rank} {mode}: {name}", file=sys.stderr,
              flush=True)

    it = torch.zeros((), dtype=torch.int32, device=dev)
    done = torch.zeros((), dtype=torch.bool, device=dev)
    body_stream, pool = torch.cuda.Stream(), torch.cuda.MemPool()
    graph = torch.cuda.CUDAGraph()
    first = None
    step("capture_begin")
    with torch.cuda.stream(side):
        graph.capture_begin(capture_error_mode="thread_local")
        try:
            x.fill_(1.0)
            it.zero_()
            if mode == "unrolled":
                for _ in range(n_iter):
                    step("all_reduce")
                    dist.all_reduce(x)
            else:
                step("while_begin")
                with graph_loop.while_node(it, done, n_iter, body_stream,
                                           pool):
                    step("all_reduce")
                    dist.all_reduce(x)
                    it.add_(1)
                    step("while_end")
        except Exception as exc:
            first = exc
        finally:
            step("capture_end")
            try:
                graph.capture_end()
            except Exception as exc:
                first = first or exc
    if first is not None:
        rec.update(captured=False, stage=stage[-2] if len(stage) > 1
                   else stage[-1], error=f"{type(first).__name__}: "
                   f"{first}"[:700])
        return rec
    step("replay")
    graph.replay()
    torch.cuda.synchronize()
    step("replayed")
    rec.update(captured=True, equal_to_eager=bool(torch.equal(x, eager)),
               value=float(x[0]), expected=float(world ** n_iter))
    t0 = time.time()
    for _ in range(20):
        graph.replay()
    torch.cuda.synchronize()
    rec["replay_ms"] = (time.time() - t0) * 1e3 / 20
    return rec


def reductions_per_iteration(step, n: int, reps: int = 50) -> dict:
    """The collectives of one ICP iteration of the point-to-plane solve,
    each timed alone between CUDA events over ``reps`` calls after a
    barrier: the reading's ``all_reduce(MIN)`` and the claims'
    ``all_reduce(SUM)`` (``n`` floats, on every ``rematch_every``-th
    iteration) and the packed ``all_reduce(SUM)`` of the normal equations
    (44 floats, every iteration)."""
    import torch.distributed as dist
    from norlab_icp_mapper_tpu_torch.icp.engine import _rematch_every
    from norlab_icp_mapper_tpu_torch.parallel.sharded_map import MIN, SUM
    dev = torch.device("cuda")
    out = {}
    for name, size, op in (("min_reading", n, MIN), ("sum_claims", n, SUM),
                           ("sum_pack", 6 * 6 + 6 + 2, SUM)):
        t = torch.ones(size, device=dev)
        step._reduce(t, op)
        torch.cuda.synchronize()
        dist.barrier()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(reps):
            step._reduce(t, op)
        e1.record()
        torch.cuda.synchronize()
        out[f"reduce_ms_{name}"] = e0.elapsed_time(e1) / reps
    r = _rematch_every()
    out["reduce_ms_per_iteration"] = (
        (out["reduce_ms_min_reading"] + out["reduce_ms_sum_claims"]) / r
        + out["reduce_ms_sum_pack"])
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--probe", choices=PROBES)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("sharded_cards: no CUDA device", file=sys.stderr)
        return 1
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    if args.probe:
        import torch.distributed as dist
        from norlab_icp_mapper_tpu_torch.parallel import multihost
        multihost.initialize()
        rank, world = dist.get_rank(), dist.get_world_size()
        rec = probe_nccl_graph(rank, world, args.probe)
        print(json.dumps(rec), file=sys.stderr, flush=True)
        recs = [None] * world
        dist.all_gather_object(recs, rec)
        if rank == 0:
            print(json.dumps({"script": "sharded_cards.py --probe",
                              "ranks": recs}), flush=True)
        dist.destroy_process_group()
        return 0
    import chip_smoke as cs
    import torch.distributed as dist
    import norlab_icp_mapper_tpu_torch as nt
    from norlab_icp_mapper_tpu_torch.parallel import (make_mesh, multihost,
                                                      sharded_map as SM)

    from norlab_icp_mapper_tpu_torch.utils import tracing
    multihost.initialize()
    rank, world = dist.get_rank(), dist.get_world_size()
    tracing.set_overflow_sink(tracing.accumulate_overflow)
    mesh = make_mesh()
    scans, poses = cs.make_sequence(args.seed, cs.N_SCANS)
    rng = np.random.default_rng(args.seed + 1)
    priors = [poses[0]] + [cs.perturb(p, rng) for p in poses[1:]]

    # CUDA events around every solve that replays its graph (not around the
    # one that captures it) and every gather of the merge, read once at the
    # end (no host wait in the loop); a captured reduction has no event of
    # its own, so the solve's reductions are timed alone after the drive
    events = {"solve": [], "gather": []}
    flags = {"merge": False}
    gathered = [0]
    gat = SM.ShardedMapperStep._gather
    solve, merge = SM.ShardedMapperStep.icp_solve, SM.ShardedMapperStep.merge

    def timed_gather(self, t):
        if not flags["merge"]:
            return gat(self, t)
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        out = gat(self, t)
        e1.record()
        events["gather"].append((e0, e1))
        gathered[0] += out.numel() * out.element_size()
        return out

    def timed_solve(self, *a, **k):
        captures = self.graph_captures
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        out = solve(self, *a, **k)
        e1.record()
        if self.graph_captures == captures:
            events["solve"].append((e0, e1, out[2]))
        return out

    def flagged_merge(self, *a, **k):
        flags["merge"] = True
        try:
            return merge(self, *a, **k)
        finally:
            flags["merge"] = False

    SM.ShardedMapperStep._gather = timed_gather
    SM.ShardedMapperStep.icp_solve = timed_solve
    SM.ShardedMapperStep.merge = flagged_merge

    mapper = nt.Mapper(os.path.join(here, "examples", "config_p2plane.yaml"),
                       is_3d=True, device="cuda", seed=0, mesh=mesh,
                       sharded_options=cs.SHARDED_OPTIONS)
    batches = [nt.PointBatch.from_numpy(s, capacity=cs.SCAN_CAPACITY,
                                        device="cuda") for s in scans]
    per_scan = []
    for i, (b, prior) in enumerate(zip(batches, priors)):
        torch.cuda.synchronize()
        dist.barrier()
        t0 = time.time()
        mapper.process_input(mapper.apply_input_filters(b), prior,
                             int(i * 1e8))
        mapper.drain()
        torch.cuda.synchronize()
        per_scan.append((time.time() - t0) * 1e3)
    sh = mapper._sharded
    solve_ms = [a.elapsed_time(b) for a, b, _ in events["solve"]]
    live = [int(it) for _, _, it in events["solve"]]
    gather_ms = sum(a.elapsed_time(b) for a, b in events["gather"])
    reduce = reductions_per_iteration(sh.step, cs.SCAN_CAPACITY)
    est = np.stack(mapper.get_trajectory().poses)
    g = mapper.get_map()
    count = torch.tensor([int(sh.state["msk"].sum())], device="cuda")
    counts = [torch.zeros_like(count) for _ in range(world)]
    dist.all_gather(counts, count)
    # every rank's replicated state against rank 0's
    mine = [est.tobytes(), sh.table_np.tobytes(), str(sh.window.w).encode(),
            g["positions"].tobytes()]
    digest = torch.tensor([int(hashlib.sha256(x).hexdigest()[:15], 16)
                           for x in mine], dtype=torch.int64, device="cuda")
    all_d = [torch.zeros_like(digest) for _ in range(world)]
    dist.all_gather(all_d, digest)
    if rank == 0:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True).stdout.strip().splitlines()
        rec = {
            "script": "sharded_cards.py", "nvidia_smi": smi,
            "world_size": world, "backend": dist.get_backend(),
            "scans": len(scans), "per_scan_ms": [round(v, 2)
                                                  for v in per_scan],
            "steady_ms_per_scan": statistics.mean(per_scan[2:]),
            "solve_graph_captures": sh.step.graph_captures,
            "solve_ms_per_scan_replays": statistics.mean(solve_ms),
            "solve_ms_per_scan_replays_median": statistics.median(solve_ms),
            "iterations_on_device_per_scan": sh.cfg.max_iter,
            "iterations_live_mean": statistics.mean(live),
            "solve_ms_per_iteration_on_device":
                statistics.mean(solve_ms) / sh.cfg.max_iter,
            **reduce,
            "halo_gather_ms_per_merge": gather_ms / max(sh._merges, 1),
            "halo_bytes_per_merge_per_rank": gathered[0] / max(sh._merges,
                                                               1),
            "recovered_ate_m": cs.ate(list(est[1:]), poses[1:]),
            "final_map_count": int(g["positions"].shape[0]),
            "block_counts": [int(c) for c in counts],
            "block_capacity": sh.capacity(), "balance": sh.balance,
            "waits": dict(sh.waits),
            "overflow_tiles_rank0": tracing.overflow_totals(),
            "overflow_totals": dict(sh.overflow_totals),
            "ranks_bit_identical": all(bool(torch.equal(d, all_d[0]))
                                       for d in all_d),
        }
        line = json.dumps(rec)
        print(line, flush=True)
        out = os.path.join(here, "chiprun_out")
        os.makedirs(out, exist_ok=True)
        with open(os.path.join(out, f"sharded_cards_w{world}.json"),
                  "w") as fh:
            fh.write(line + "\n")
    # NCCL destroys no communicator while a graph that captured its
    # collectives lives: the mapper frees its solve graphs first
    mapper.shutdown()
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
