"""One rank of the port's ``DistributedICP`` (``run_rank``, for
``tests/test_torch_distributed.py``) or of its ``ShardedMapper``
(``run_sharded_rank``, for ``tests/test_torch_sharded_ranks.py``) over gloo,
started by ``torch.multiprocessing.spawn``; imports neither JAX nor the JAX
package."""
import os
import sys

import numpy as np


def run_rank(rank, world, port, out_dir, case):
    import torch
    torch.set_num_threads(1)
    import torch.distributed as dist
    from norlab_icp_mapper_tpu_torch.parallel import (DistributedICP,
                                                      make_mesh, multihost)
    for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        os.environ.pop(k, None)
    # torchrun's variables, as a launcher sets them
    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                      WORLD_SIZE=str(world), RANK=str(rank))
    multihost.initialize(device="cpu")
    try:
        checks = {"process_count": multihost.process_count(),
                  "process_index": multihost.process_index()}
        mesh = make_mesh(world)
        blocks = [multihost.make_global_array(case[k], mesh)
                  for k in ("map_pos", "map_norm", "map_mask")]
        checks["block_is_own_shard"] = all(
            np.array_equal(b.numpy(), case[k][rank:rank + 1])
            for b, k in zip(blocks, ("map_pos", "map_norm", "map_mask")))
        checks["block_dtypes"] = [str(b.dtype) for b in blocks]
        icp = DistributedICP(mesh, max_dist=case["max_dist"],
                             max_iter=case["max_iter"])
        T, overlap, rms = icp.solve(case["read_pos"], case["read_mask"],
                                    *blocks)
        checks["jax_imported"] = any(
            m == "jax" or m.startswith("jax.")
            or m.startswith("norlab_icp_mapper_tpu.")
            or m == "norlab_icp_mapper_tpu" for m in sys.modules)
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), T=T.numpy(),
                 overlap=overlap.numpy(), rms=rms.numpy(), **{
                     k: np.asarray(v) for k, v in checks.items()})
    finally:
        dist.destroy_process_group()


def sharded_config(case):
    """The case's ``ShardedMapConfig``: its keyword arguments, and a step
    chain from the case's ``step_yaml`` (a filter chain does not cross the
    spawn, its YAML does)."""
    from norlab_icp_mapper_tpu_torch.filters.core import FilterChain
    from norlab_icp_mapper_tpu_torch.parallel import ShardedMapConfig
    kw = dict(case["cfg"])
    if case.get("step_yaml"):
        kw["step_filter"] = FilterChain.from_yaml(case["step_yaml"])._apply_impl
    return ShardedMapConfig(**kw)


def run_sharded_rank(rank, world, port, out_dir, job):
    """One rank of the port's ``ShardedMapper`` over gloo: every case of
    ``job["cases"]`` in turn, drained after every scan; each case's poses,
    map and replicated host state go to ``<case>_rank<r>.npz``."""
    import torch
    torch.set_num_threads(1)
    import torch.distributed as dist
    from norlab_icp_mapper_tpu_torch import PointBatch
    from norlab_icp_mapper_tpu_torch.parallel import (ShardedMapConfig,
                                                      ShardedMapper,
                                                      make_mesh, multihost)
    for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        os.environ.pop(k, None)
    os.environ["NIM_TPU_REMATCH_EVERY"] = str(job.get("rematch", 3))
    multihost.initialize(f"127.0.0.1:{port}", world, rank, device="cpu")
    try:
        mesh = make_mesh(world)
        for case in job["cases"]:
            sm = ShardedMapper(mesh, sharded_config(case), device="cpu")
            for k, v in case.get("attrs", {}).items():
                setattr(sm, k, v)
            iters = []
            for i, (scan, est) in enumerate(zip(case["scans"],
                                                case["ests"])):
                sm.process_input(PointBatch.from_numpy(scan, device="cpu"),
                                 est, stamp_s=0.1 * i)
                if i == 0 and case.get("zero_table"):
                    # every bucket on rank 0, as a skewed table would
                    sm.table_np = np.zeros_like(sm.table_np)
                    sm.table = sm._table_dev(sm.table_np)
                sm.drain()
                iters.append(-1 if sm.last_iterations is None
                             else int(sm.last_iterations))
            m = sm.drain()
            g = sm.get_map()
            cells = sorted(sm.cell_manager.get_all_cell_ids())
            np.savez(
                os.path.join(out_dir, f"{case['name']}_rank{rank}.npz"),
                poses=np.stack(sm.trajectory.poses),
                positions=g["positions"], normals=g["normals"],
                prob=g["probabilityDynamic"], table=sm.table_np,
                window=np.asarray(sm.window.w if sm.window is not None
                                  and sm.window.w is not None else []),
                cells=np.asarray(cells, dtype=str), count=m["count"],
                max_shard_count=m["max_shard_count"],
                insert_overflow=m["insert_overflow"],
                halo_overflow=m["halo_overflow"],
                balance=-1.0 if sm.balance is None else sm.balance,
                last_rebalance=sm._last_rebalance_scan,
                rebalance_overflow=sm.overflow_totals.get("rebalance", 0),
                capacity=sm.capacity(), q_tile=sm.step.block_q_tile,
                iters=np.asarray(iters),
                jax_imported=any(
                    k == "jax" or k.startswith("jax.")
                    or k == "norlab_icp_mapper_tpu"
                    or k.startswith("norlab_icp_mapper_tpu.")
                    for k in sys.modules))
    finally:
        dist.destroy_process_group()
