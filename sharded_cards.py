#!/usr/bin/env python3
"""The sharded mapper over NCCL on the cards of one host.

    torchrun --standalone --nproc-per-node N sharded_cards.py [--seed 0]

Every rank makes ``chip_smoke.py``'s hall sequence (18 scans of 49,152 rays)
from the seed and drives ``Mapper("examples/config_p2plane.yaml",
mesh=make_mesh())`` over it with the p2plane priors, drained after every
scan.  Rank 0 prints one JSON line (and writes it to
``chiprun_out/sharded_cards_w<N>.json``): the card's name and power limit,
the world size, steady ms per scan, the ICP iterations' time and the time
its reductions take (CUDA events around each reduction, on the stream that
waits for it), the halo's gathered bytes per merge, ATE, map size, each
rank's block count and capacity, the balance, rank 0's overflowing search
windows by pass (``utils.tracing``), and whether every rank ends
with the same poses, table, window and map bit for bit.  Needs one card
per rank; exits non-zero without CUDA.
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


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("sharded_cards: no CUDA device", file=sys.stderr)
        return 1
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
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

    # CUDA events around every reduction of the solve and every gather of
    # the merge, read once at the end (no host wait in the loop)
    events = {"reduce": [], "gather": []}
    flags = {"solve": False, "merge": False}
    gathered = [0]
    red, gat = SM.ShardedMapperStep._reduce, SM.ShardedMapperStep._gather
    solve, merge = SM.ShardedMapperStep.icp_solve, SM.ShardedMapperStep.merge

    def timed(kind, fn, flag):
        def call(self, *a, **k):
            if not flags[flag]:
                return fn(self, *a, **k)
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            out = fn(self, *a, **k)
            e1.record()
            events[kind].append((e0, e1))
            if kind == "gather":
                gathered[0] += out.numel() * out.element_size()
            return out
        return call

    def flagged(fn, flag):
        def call(self, *a, **k):
            flags[flag] = True
            try:
                return fn(self, *a, **k)
            finally:
                flags[flag] = False
        return call

    SM.ShardedMapperStep._reduce = timed("reduce", red, "solve")
    SM.ShardedMapperStep._gather = timed("gather", gat, "merge")
    SM.ShardedMapperStep.icp_solve = flagged(solve, "solve")
    SM.ShardedMapperStep.merge = flagged(merge, "merge")

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
    reduce_ms = sum(a.elapsed_time(b) for a, b in events["reduce"])
    gather_ms = sum(a.elapsed_time(b) for a, b in events["gather"])
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
    n_it = (len(scans) - 1) * sh.cfg.max_iter
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
            "reductions_in_solve": len(events["reduce"]),
            "reduce_ms_per_iteration": reduce_ms / n_it,
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
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
