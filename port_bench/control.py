"""The readings that the limits of ``correct`` are set from, for one cell.

    python3 port_bench/control.py --workload <cell> --seconds <s> \\
        --seeds <n> [<n> ...] [--control-seeds <n> ...]

For every seed: the cell's set-up and a window of ``--seconds`` at the
cell's own load, then the numbers of ``correct`` for what the program
produced (the lower readings).  For the control seeds also the control:
the plain reference put in the program's place for the same sampled
scans, from the same state, with its matrix products in TF32 (the
configuration states float32 with TF32 off), judged by the same numbers
(the upper readings).  With ``--fault`` the program runs with that fault
planted (``harness/faults.py``).  One JSON line per seed.  Not part of a
benchmark run.
"""
from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
sys.path.insert(0, str(BENCH))
sys.path.insert(0, str(BENCH.parent))

from harness.faults import FAULTS  # noqa: E402


def readings(cell, seed, seconds, device, control, scale=None):
    import torch
    from harness import outcome
    from harness.cell import Run
    from reference.judge import control_outputs, judge
    from reference.nn import tf32

    run = Run(cell, seed, seconds, False, device, time.perf_counter(), scale)
    run.setup()
    run.window()
    outs = outcome.collect(run)
    outcome.free_program(run)
    dev = torch.device(device)
    cfg = cell.config["mapper_config"]
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 1)
    program = judge(cfg, outs["samples"], dev, gen)
    line = {"seed": seed, "program": program, "scans": run.attempted}
    if control:
        swapped = []
        for s in outs["samples"]:
            if s["bootstrap"]:
                continue
            with tf32():
                pose, after, ref = control_outputs(cfg, s, dev, gen)
            swapped.append(dict(s, pose=pose, after=after, next=None,
                                ref=ref))
        line["control"] = judge(cfg, swapped, dev, gen)
    return line


def main(argv=None, device="cuda", scale=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--fault", choices=sorted(FAULTS),
                    help="plant this fault in the program first")
    args = ap.parse_args(argv)
    import torch
    from harness import faults, manifest
    if args.fault:
        faults.plant(args.fault)
    torch.backends.cuda.matmul.allow_tf32 = False
    cell = manifest.Cell(manifest.load_manifest(), args.workload)
    lines = []
    for seed in args.seeds + args.control_seeds:
        t = time.perf_counter()
        line = readings(cell, seed, args.seconds, device,
                        seed in args.control_seeds, scale)
        line["s"] = time.perf_counter() - t
        print(json.dumps(line), flush=True)
        lines.append(line)
    return lines


if __name__ == "__main__":
    main()
