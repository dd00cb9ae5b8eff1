"""State of the JAX package, as numpy arrays, into the port's.

The system has no weights; its state is clouds and poses.  These functions
take what ``np.asarray`` gives for the JAX package's device arrays (the
caller does that conversion: this module imports nothing of JAX) and build
the port's objects, so that a test can run scan *n+1* in both packages from
the same state.
"""
from __future__ import annotations

from typing import Dict, Iterable, Optional

import numpy as np
import torch

from .draws import resolve_device
from .points import PointBatch
from .ops.nn_sweep import RefPack, pack_rows4

__all__ = ["point_batch_from_numpy", "presort_pack_from_numpy",
           "mapper_state_from_numpy", "keyframes_from_numpy",
           "sharded_state_from_numpy"]


def point_batch_from_numpy(positions: np.ndarray, mask: np.ndarray,
                           descriptors: Optional[Dict[str, np.ndarray]] = None,
                           device="cuda") -> PointBatch:
    """Full-capacity arrays of a JAX ``PointBatch`` -> the port's.

    Mask and padding rows are preserved bit for bit (this is not the
    compacted dict that ``PointBatch.to_numpy`` returns)."""
    dev = resolve_device(device)
    pos = torch.from_numpy(np.array(positions, dtype=np.float32)).to(dev)
    msk = torch.from_numpy(np.array(mask, dtype=bool)).to(dev)
    if pos.ndim != 2 or msk.shape != (pos.shape[0],):
        raise ValueError("positions must be [C, D] and mask [C]")
    desc = {}
    for name, v in (descriptors or {}).items():
        v = np.array(v, dtype=np.float32)
        if v.ndim == 1:
            v = v[:, None]
        if v.shape[0] != pos.shape[0]:
            raise ValueError(f"descriptor '{name}' has {v.shape[0]} rows, "
                             f"expected {pos.shape[0]}")
        desc[name] = torch.from_numpy(v).to(dev)
    return PointBatch(pos, msk, desc)


def presort_pack_from_numpy(ref_s, ref_mask_s, ref_xs, ref_order, ref_planar,
                            center, device="cuda") -> RefPack:
    """The six fields of the JAX package's ``presort_ref`` -> the port's
    ``RefPack``.  The sorted coordinates go into the port's ``f32[M, 4]``
    layout with ``ref_order`` in the fourth lane.  ``ref_planar`` (the
    ``[8, M_pad]`` layout of the TPU kernel) has no counterpart and is
    ignored; the count of valid refs takes its place."""
    del ref_planar
    dev = resolve_device(device)
    mask = torch.from_numpy(np.array(ref_mask_s, dtype=bool)).to(dev)
    order = torch.from_numpy(np.array(ref_order, dtype=np.int64)).to(dev)
    coords = torch.from_numpy(np.array(ref_s, dtype=np.float32)).to(dev)
    return RefPack(
        pack_rows4(coords, order),
        mask,
        torch.from_numpy(np.array(ref_xs, dtype=np.float32)).to(dev),
        order,
        mask.sum(),
        torch.from_numpy(np.array(center, dtype=np.float32)).to(dev))


def mapper_state_from_numpy(mapper, map_arrays, ref_arrays=None, pose=None,
                            last_pose=None, last_time_ns=None, window=None,
                            loaded_cell_ids: Iterable[str] = (),
                            cells: Optional[Dict[str, Dict[str, np.ndarray]]]
                            = None) -> None:
    """Put a port ``Mapper`` into the state of a JAX ``Mapper`` after
    ``drain()``.

    ``map_arrays`` / ``ref_arrays``: ``(positions, mask, descriptors)`` of
    the local cloud and (when the engine has reference filters) of the ICP
    reference, at full capacity.  ``pose`` / ``last_pose``: latest corrected
    pose and pose at the last map update.  ``last_time_ns``: stamp of the
    last map update (``-inf`` for none).  ``window``: the rolling window's
    six grid bounds, or None if the first pose update is still pending.
    ``cells``: the saved (evicted) cells, id -> host dict."""
    dev = mapper.device
    mapper.drain()  # nothing of the port's own loop stays in flight
    local = point_batch_from_numpy(*map_arrays, device=dev)
    mapper.map.set_local(local, None, mapper.draws)
    if ref_arrays is not None:
        # the reference-filtered map (e.g. with the normals of the default
        # config's SurfaceNormal reference filter) replaces what set_local
        # computed, and the matcher's pack is rebuilt for it
        mapper.icp._ref = point_batch_from_numpy(*ref_arrays, device=dev)
        mapper.icp._ref_pack = mapper.icp.build_ref_pack(mapper.icp._ref)
    mapper.map.new_local_available = False
    d = mapper.dim
    eye = np.eye(d + 1, dtype=np.float32)
    mapper.pose = None if pose is None else np.array(pose, dtype=np.float32)
    mapper.last_pose_where_map_was_updated = (
        eye if last_pose is None else np.array(last_pose, dtype=np.float32))
    mapper.last_time_map_was_updated = (
        -np.inf if last_time_ns is None or not np.isfinite(last_time_ns)
        else int(last_time_ns))
    mapper._fused_state = None
    mapper._fused_base_count = None
    mapper._win_corr = None
    mapper._epoch_ns = None
    if window is None:
        mapper.map.first_pose_update = True
        mapper.map._window = None
    else:
        mapper.map.first_pose_update = False
        mapper.map._window = [int(v) for v in window]
    mapper.map.loaded_cell_ids = set(loaded_cell_ids)
    mapper.map.cell_manager.clear_all_cells()
    for cid, cell in (cells or {}).items():
        mapper.map.cell_manager.save_cell(
            cid, {k: np.array(v) for k, v in cell.items()})


def keyframes_from_numpy(mapper, positions, masks, poses,
                         cfg: Optional[Dict] = None) -> None:
    """Put the JAX ``Mapper``'s keyframe store into a port ``Mapper``.

    ``positions [K, cap, D]``, ``masks [K, cap]`` and ``poses [K, D+1, D+1]``
    are the JAX ``get_keyframes()`` as numpy (its padded stack: each
    keyframe keeps the common capacity).  ``cfg`` is the JAX store's
    configuration (``min_distance``, ``max_keyframes``,
    ``thinning_events``); without it the port's is kept, or
    ``enable_keyframes()``'s defaults are set."""
    dev = mapper.device
    pos = np.asarray(positions, dtype=np.float32)
    msk = np.asarray(masks, dtype=bool)
    poses = np.asarray(poses, dtype=np.float32)
    if pos.ndim != 3 or msk.shape != pos.shape[:2] \
            or poses.shape[0] != pos.shape[0]:
        raise ValueError("positions must be [K, cap, D], masks [K, cap] and "
                         "poses [K, D+1, D+1]")
    if cfg is not None:
        mapper._kf_cfg = dict(cfg)
    elif mapper._kf_cfg is None:
        mapper.enable_keyframes()
    mapper._keyframes = [
        (torch.from_numpy(pos[k].copy()).to(dev),
         torch.from_numpy(msk[k].copy()).to(dev), poses[k].copy())
        for k in range(pos.shape[0])]


def sharded_state_from_numpy(blocks: Dict[str, np.ndarray], table,
                             mesh, device=None):
    """The JAX ``ShardedMapper``'s state, as numpy, into the port's: the
    ``[S, cap, ...]`` blocks (``pos``, ``nrm``, ``msk``, ``prob``) and the
    bucket table every rank passes whole.  Returns ``(state, table)``:
    this rank's block (block ``rank`` of the mesh's axis) and the table as
    tensors on ``device`` (default the card; see
    ``parallel.sharded_map.shard_device``).  Assign them to a
    ``ShardedMapper``'s ``state`` / ``table`` (and ``table_np``)."""
    from .parallel.sharded_map import shard_device
    from .draws import upload
    dev = shard_device(mesh, device)
    axis = mesh.mesh_dim_names[0]
    S = mesh.size(0)
    r = mesh.get_local_rank(axis)
    if np.asarray(blocks["pos"]).shape[0] != S:
        raise ValueError(f"{np.asarray(blocks['pos']).shape[0]} blocks for "
                         f"{S} ranks")
    dtypes = {"pos": torch.float32, "nrm": torch.float32,
              "msk": torch.bool, "prob": torch.float32}
    state = {k: upload(np.ascontiguousarray(np.asarray(blocks[k])[r]), dev,
                       dt) for k, dt in dtypes.items()}
    return state, upload(np.asarray(table, np.int64), dev, torch.int64)
