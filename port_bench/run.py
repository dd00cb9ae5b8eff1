"""Runs one cell of the benchmark of ``norlab_icp_mapper_tpu_torch`` once.

    python3 port_bench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

From the root of a checkout on a machine with the cards the cell asks for.
The last line of standard output is the result as one JSON object; the
numbers that decided ``correct`` are the last lines of standard error.
"""
from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None, device: str = "cuda", scale=None, cell=None) -> int:
    """``device``, ``scale`` (a smaller sensor and laps) and ``cell`` are
    for the benchmark's own tests on the CPU; the command line has none."""
    args = parse(argv)
    sys.path.insert(0, str(BENCH))
    sys.path.insert(0, str(ROOT))
    import torch
    from harness import manifest, outcome
    from harness.cell import Run
    from reference.judge import judge

    if cell is None:
        cell = manifest.Cell(manifest.load_manifest(ROOT), args.workload)
    if device == "cuda":
        if not torch.cuda.is_available():
            print("no CUDA device", file=sys.stderr)
            return 2
        if torch.cuda.device_count() < cell.chips:
            print(f"{cell.name} needs {cell.chips} cards, "
                  f"{torch.cuda.device_count()} here", file=sys.stderr)
            return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(4)

    run = Run(cell, args.seed, args.seconds, bool(args.trace), device,
              T_PROCESS, scale)
    run.setup()
    e2e = run.window()
    dev = torch.device(device)
    if run.on_card:
        torch.cuda.synchronize(dev)
        peak = torch.cuda.max_memory_allocated(dev)
        info = {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
                "count": cell.chips, "memory_peak_bytes": int(peak)}
    else:
        info = {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}
    result = {"correct": False, "attempted": run.attempted,
              "failed": run.failed}
    if args.trace:
        ctx = outcome.layer_context(run)
        metrics = {}
        for name, read in cell.readers().items():
            v = read(ctx)
            if v is not None:
                metrics[name] = {"value": float(v), "unit": cell.unit(name)}
        prof = run.profile or {}
        if prof:
            info.update(busy_s=prof["busy_s"], window_s=prof["window_s"])
            result["breakdown"] = {"device_ops": prof["device_ops"],
                                   "idle_gaps": prof["idle_gaps"]}
    else:
        metrics = {m["name"]: {"value": float(e2e[m["name"]]),
                               "unit": m["unit"]} for m in cell.end_to_end}
    result["metrics"] = metrics
    result["device"] = info

    diag = {"setup_split_s": run.setup_split, "window_s": run.t_window,
            "window_counts": {k: v for k, v in run.window_counts.items()
                              if k != "phases_ms"},
            "warm_scans": len(run.warm_idx), "end_to_end": e2e,
            "map_points": run.map_points}
    ts = run.t_scans
    if len(ts) > 4:
        h = len(ts) // 2
        diag["scans_per_s_halves"] = [h / (ts[h] - ts[0]),
                                      (len(ts) - 1 - h) / (ts[-1] - ts[h])]
    if hasattr(run, "latencies"):
        diag["latency_ms"] = sorted(1e3 * x for x in run.latencies)[-12:]
        diag["hand_over_late_ms_max"] = 1e3 * max(run.lateness)
    print("diag " + json.dumps(diag), file=sys.stderr)
    t_judge = time.perf_counter()
    outs = outcome.collect(run) if run.error is None else None
    outcome.free_program(run)
    limits = run.check["limits"]
    if outs is None:
        print(f"the mapper failed in the window: {run.error}",
              file=sys.stderr)
        values = {name: float("inf") for name in limits}
    else:
        gen = torch.Generator(device=dev)
        gen.manual_seed(args.seed + 1)
        values = judge(cell.config["mapper_config"], outs["samples"], dev,
                       gen)
    print(f"judge_s {time.perf_counter() - t_judge:.3f} " + json.dumps(
        {k: v for k, v in values.items() if k not in limits}),
        file=sys.stderr)
    checks = outcome.checks_line(values, limits)
    result["correct"] = bool(run.error is None and run.failed == 0 and all(
        c["value"] <= c["limit"] for c in checks.values()))
    loaded = outcome.forbidden_modules()
    if loaded:
        print(f"the run loaded {loaded}: a run of the port loads no JAX",
              file=sys.stderr)
        return 3
    outcome.emit(result, checks)
    return 0


if __name__ == "__main__":
    sys.exit(main())
