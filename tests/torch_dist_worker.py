"""One rank of the port's ``DistributedICP`` over gloo, for
``tests/test_torch_distributed.py`` (started by ``torch.multiprocessing.spawn``;
imports neither JAX nor the JAX package)."""
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
