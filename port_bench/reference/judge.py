"""What decides ``correct``: the outputs of the timed path held against the
plain reference, scan by scan, from the state the program held before
each sampled scan.

For a sampled scan the judge is given the raw scan, its prior, the pose
that was produced for it, and the map before and after it (valid rows:
``pos``, and where the configuration keeps them ``normals`` and ``prob``).
The reference works out again, from those alone, everything the program
derived: the input chain, the map's normals, the registration, the
MapperModules and post filters.  It reads the produced pose and map only
to judge them.  Numbers (each the worst over the sampled scans):

* ``pose_gap_median_mm``: the median, over the held runs' first scans, of
  the distance between the produced pose and the reference's registration
  of the same scan from the same prior against the same map (its own
  random reading sample).  The median, because now and then one of two
  sound registrations settles in another minimum (``pose_gap_max_mm``,
  reported beside it, read up to 149 mm on sound runs);
* ``merge_miss_share``: octree maps, the rows of the map after that break
  the merge (no point of the map or the scan under it, two in one cell, a
  point the cut should have removed) plus the cells that had to stay and
  are empty, over the cells of the union; point-distance maps, the new
  points that differ from the reference's (and the old points lost), over
  the reference's new points;
* ``prob_miss_share``: the map's old rows whose ``probabilityDynamic``
  differs from the reference's update by more than ``PROB_TOL``;
* ``ref_normal_miss_share``: where the ICP's reference filter is
  SurfaceNormal by k-NN (the defaults), the rows of the solve's reference
  after a held scan whose normal is more than ``NORMAL_TOL_DEG`` from the
  reference's k-NN normal on the same points;
* ``normal_miss_share``: the map's rows whose normal is more than
  ``NORMAL_TOL_DEG`` from the reference's normal on the same points (rows
  near a point that the cut after the normals may have removed are not
  judged).

The judgement follows the program step by step: the map before a sampled
scan, with the normals and probabilities it holds, is the program's state
that the reference starts from.  ``normal_miss_share`` and
``prob_miss_share`` judge those descriptors where they are made, and the
map's first scan is judged from the scan alone.

* ``handover_miss_share``: the rows that differ between the map a sampled
  scan left and the map the next scan starts from, over the former's: the
  hand-over from scan to scan that the per-scan judgement takes on trust.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from .filters import input_chain
from .icp import IcpConfig, register, rotation_angle, transform
from .merge import (angle_between, dynamic_probabilities, octree_merge,
                    point_distance_new, voxel_keys)
from .nn import knn
from .normals import knn_normals, radius_normals

MATCH_TOL_M = 1e-4  # a map row is a candidate point moved by rounding only
PROB_TOL = 1e-3
NORMAL_TOL_DEG = 1.0
REFS_JUDGED = 2  # solve references judged per run (each a k-NN pass)


class MergeRules:
    """The merge the configuration names, read from its mapper YAML tree."""

    def __init__(self, cfg):
        mapper = (cfg or {}).get("mapper") or {}
        mods = {}
        for m in mapper.get("mapperModule") or [
                {"PointDistanceMapperModule": {"minDistNewPoint": 0.15}}]:
            (name, p), = m.items()
            mods[name] = dict(p or {})
        self.modules = mods
        self.octree = "OctreeMapperModule" in mods
        cond = mapper.get("updateCondition") or {"type": "distance",
                                                 "value": 1.0}
        self.condition = (cond["type"], float(cond["value"]))
        self.icp = IcpConfig.from_mapper_config(cfg)
        # the ICP's reference filter: libpointmatcher's default is
        # SurfaceNormal with k = 10 and no distance bound
        ref_filters = ((cfg or {}).get("icp") or {}).get(
            "referenceDataPointsFilters", [] if cfg else
            [{"SurfaceNormalDataPointsFilter": {"knn": 10}}]) or []
        self.icp_knn_normals = None
        for f in ref_filters:
            (name, p), = f.items()
            if (name != "SurfaceNormalDataPointsFilter"
                    or math.isfinite(float(p.get("maxDist", math.inf)))):
                raise ValueError(f"reference: no reference filter {f}")
            self.icp_knn_normals = int(p.get("knn", 5))
        self.post = None
        for f in (cfg or {}).get("post") or []:
            (name, p), = f.items()
            if name == "SurfaceNormalDataPointsFilter":
                self.post = {"maxDist": float(p["maxDist"]),
                             "minCount": min(int(p.get("knn", 5)), 3)}
            elif name == "CutAtDescriptorThresholdDataPointsFilter":
                self.post_threshold = float(p["threshold"])
        if self.octree:
            dyn = {"thresholdDynamic": 0.6, "alpha": 0.8, "beta": 0.99,
                   "beamHalfAngle": 0.01, "epsilonA": 0.01,
                   "epsilonD": 0.01,
                   "sensorMaxRange": float(mapper.get("sensorMaxRange",
                                                      200.0))}
            dyn.update(mods["DynamicPointsMapperModule"])
            self.modules["DynamicPointsMapperModule"] = dyn
            self.post.update(threshold=self.post_threshold)

    def map_normals(self, before: dict) -> torch.Tensor:
        """The normals the solve sees on the map ``before``: worked out
        again for a reference filter's k-NN normals; on a map that keeps
        its post filter's normals, the map's own (the state the scan starts
        from; ``normal_miss_share`` judges them where they are made)."""
        if self.icp_knn_normals:
            return knn_normals(before["pos"], self.icp_knn_normals)
        return before["normals"]

    def expect_merge(self, pose, stamp, last_pose, last_stamp) -> bool:
        """The update condition (the map's first scan always merges)."""
        kind, value = self.condition
        if last_pose is None:
            return True
        if kind == "distance":
            return float(np.linalg.norm(
                np.asarray(pose, np.float64)[:3, 3] - last_pose[:3, 3])) > value
        if kind == "delay":
            return stamp - last_stamp > value
        raise ValueError(f"reference: no update condition {kind}")


def merge_decisions(cfg, poses, stamps_s):
    """Which scans the update condition merges, taken along the produced
    poses and the stamps from the map's first scan: ``(merges, last)``,
    ``last[k]`` the pose and stamp of the last merge before scan ``k``."""
    rules = MergeRules(cfg)
    merges, last, prev = [], [], (None, None)
    for pose, stamp in zip(poses, stamps_s):
        last.append(prev)
        m = rules.expect_merge(pose, stamp, *prev)
        merges.append(m)
        if m:
            prev = (np.asarray(pose, np.float64), stamp)
    return merges, last


def _as_t(x, dev):
    return torch.as_tensor(x, dtype=torch.float32, device=dev)


def _matched(a: torch.Tensor, b: torch.Tensor):
    """``(hit bool[A], idx i64[A])``: the row of ``b`` each row of ``a``
    lies on, within MATCH_TOL_M."""
    if b.shape[0] == 0:
        return (torch.zeros(a.shape[0], dtype=torch.bool, device=a.device),
                torch.zeros(a.shape[0], dtype=torch.int64, device=a.device))
    d2, idx = knn(a, b, 1)
    return d2[:, 0] < MATCH_TOL_M ** 2, idx[:, 0].clamp(min=0)


def _octree_misses(rules, scan_s, prob0, pose, before, after, ref_normals):
    """``(merge_miss_share, prob_miss_share, normal_miss_share)``."""
    dyn = rules.modules["DynamicPointsMapperModule"]
    size = rules.modules["OctreeMapperModule"]["maxSizeByNode"]
    thr = rules.post["threshold"]
    if before["pos"].shape[0]:
        old_prob = dynamic_probabilities(scan_s, before["pos"], ref_normals,
                                         before["prob"], pose, dyn)
    else:
        old_prob = before["prob"]
    scan_m = transform(pose, scan_s)
    cand = torch.cat([before["pos"], scan_m])
    cand_prob = torch.cat([old_prob, prob0])
    n_old = before["pos"].shape[0]
    hit, idx = _matched(after["pos"], cand)
    cells_all, cell_of = torch.unique(voxel_keys(cand, size),
                                      return_inverse=True)
    n_cells = cells_all.shape[0]
    row_cell = cell_of[idx][hit]
    per_cell = torch.bincount(row_cell, minlength=n_cells)
    stays = torch.ones(n_cells, dtype=torch.int32, device=cand.device)
    stays = stays.scatter_reduce(0, cell_of, (cand_prob <= thr).int(),
                                 reduce="amin").bool()
    misses = (int((~hit).sum()) + int((per_cell - 1).clamp(min=0).sum())
              + int((cand_prob[idx][hit] > thr).sum())
              + int((stays & (per_cell == 0)).sum()))
    old = hit & (idx < n_old)
    prob_miss = int((torch.abs(after["prob"][old] - cand_prob[idx][old])
                     > PROB_TOL).sum())
    # the post filter's normals saw the points the cut removed after it:
    # rows within its radius of a point the cut may have removed are not
    # judged
    r = rules.post["maxDist"]
    judged = torch.ones_like(hit)
    cut = cand[cand_prob > thr]
    if cut.shape[0]:
        d2, _ = knn(after["pos"], cut, 1, r)
        judged = torch.isinf(d2[:, 0])
    n_ref = radius_normals(after["pos"], r, rules.post["minCount"])
    normal_miss = int((angle_between(after["normals"], n_ref)
                       > math.radians(NORMAL_TOL_DEG))[judged].sum())
    return (misses / max(n_cells, 1), prob_miss / max(int(old.sum()), 1),
            normal_miss / max(int(judged.sum()), 1))


def _point_distance_misses(rules, scan_s, pose, before, after, merge,
                           unchanged):
    """``unchanged``: the map after is the map before (the same tensors)."""
    min_dist = rules.modules["PointDistanceMapperModule"].get(
        "minDistNewPoint", 0.15)
    scan_m = transform(pose, scan_s)
    ref_new = (scan_m[point_distance_new(before["pos"], scan_m, min_dist)]
               if merge else scan_m[:0])
    if unchanged:
        return ref_new.shape[0] / max(ref_new.shape[0], 1)
    old_hit, _ = _matched(after["pos"], before["pos"])
    lost, _ = _matched(before["pos"], after["pos"])
    new = after["pos"][~old_hit]
    a, _ = _matched(new, ref_new)
    b, _ = _matched(ref_new, new)
    misses = int((~a).sum()) + int((~b).sum()) + int((~lost).sum())
    return misses / max(ref_new.shape[0], 1)


def judge(cfg, samples, device, generator: torch.Generator):
    """The numbers compared, each the worst over ``samples`` (the pose gap:
    the median).  A sample:
    ``scan`` (raw, sensor frame), ``prior``, ``pose`` (produced), ``before``
    and ``after`` (dicts of valid rows on any device), ``expect_merge`` (the
    update condition along the produced poses, ``merge_decisions``),
    ``bootstrap`` (the map's first scan: nothing to register against) and
    ``solve`` (its registration is judged: the first scan of a held run;
    the scans after it hold the maps until the update condition merges)."""
    rules = MergeRules(cfg)
    normals_of = {}  # one map's normals, for the scans that share it
    worst = {"merge_miss_share": 0.0, "handover_miss_share": 0.0}
    gaps_mm, gaps_mrad = [], []
    if rules.icp_knn_normals:
        worst["ref_normal_miss_share"] = 0.0
        judged_refs = set()
    if rules.octree:
        worst.update(prob_miss_share=0.0, normal_miss_share=0.0)
    for s in samples:
        scan_raw = _as_t(s["scan"], device)
        scan_s, prob0 = input_chain(scan_raw, cfg)
        before = {k: v.to(device) for k, v in s["before"].items()}
        after = {k: v.to(device) for k, v in s["after"].items()}
        pose = _as_t(s["pose"], device)
        prior = _as_t(s["prior"], device)
        ref_normals = None
        if before["pos"].shape[0] and s.get("solve"):
            key = id(s["before"]["pos"])
            if key not in normals_of:
                normals_of[key] = rules.map_normals(before)
            ref_normals = normals_of[key]
        if s.get("solve") and before["pos"].shape[0]:
            T = register(scan_s, prior, before["pos"], ref_normals,
                         rules.icp, generator)
            gaps_mm.append(1e3 * float(torch.linalg.norm(T[:3, 3]
                                                         - pose[:3, 3])))
            gaps_mrad.append(1e3 * rotation_angle(
                pose[:3, :3].double() @ T[:3, :3].double().T))
        if rules.octree:
            m, p, n = _octree_misses(rules, scan_s, prob0, pose, before,
                                     after, before.get("normals"))
            worst["prob_miss_share"] = max(worst["prob_miss_share"], p)
            worst["normal_miss_share"] = max(worst["normal_miss_share"], n)
        else:
            m = _point_distance_misses(rules, scan_s, pose, before, after,
                                       s["expect_merge"],
                                       s["after"] is s["before"])
        worst["merge_miss_share"] = max(worst["merge_miss_share"], m)
        ref = s.get("ref")
        if rules.icp_knn_normals and ref is not None \
                and id(ref) not in judged_refs \
                and len(judged_refs) < REFS_JUDGED:
            judged_refs.add(id(ref))
            pos = ref["pos"].to(device)
            n_ref = knn_normals(pos, rules.icp_knn_normals)
            miss = (angle_between(ref["normals"].to(device), n_ref)
                    > math.radians(NORMAL_TOL_DEG)).float().mean()
            worst["ref_normal_miss_share"] = max(
                worst["ref_normal_miss_share"], float(miss))
        if s.get("next") is not None and s["next"] is not s["after"]:
            nxt = s["next"]["pos"].to(device)
            a, _ = _matched(after["pos"], nxt)
            b, _ = _matched(nxt, after["pos"])
            h = (int((~a).sum()) + int((~b).sum())) / max(a.shape[0], 1)
            worst["handover_miss_share"] = max(
                worst["handover_miss_share"], h)
    worst["pose_gap_median_mm"] = float("inf")  # no registration judged
    if gaps_mm:
        worst["pose_gap_median_mm"] = float(np.median(gaps_mm))
        # beside it, not compared: one registration of several may settle
        # in another minimum than the reference's own random sample does
        worst["pose_gap_max_mm"] = max(gaps_mm)
        worst["pose_gap_max_mrad"] = max(gaps_mrad)
    return worst


def control_outputs(cfg, s, device, generator: torch.Generator):
    """The reference put in the program's place for one sample: its own
    pose and map after, from the sample's state (the control runs it with
    lower-precision matrix products)."""
    rules = MergeRules(cfg)
    scan_s, _prob0 = input_chain(_as_t(s["scan"], device), cfg)
    before = {k: v.to(device) for k, v in s["before"].items()}
    prior = _as_t(s["prior"], device)
    normals = rules.map_normals(before)
    pose = register(scan_s, prior, before["pos"], normals, rules.icp,
                    generator)
    if rules.octree:
        pos, nrm, prob = octree_merge(
            before["pos"], normals, before["prob"], scan_s, pose,
            rules.modules, dict(rules.post, initial=float(_prob0[0])),
            generator)
        after = {"pos": pos, "normals": nrm, "prob": prob}
    else:
        merge = rules.expect_merge(pose.cpu().numpy(), s["stamp"],
                                   *s["last_merge_pose"])
        scan_m = transform(pose, scan_s)
        min_dist = rules.modules["PointDistanceMapperModule"].get(
            "minDistNewPoint", 0.15)
        new = scan_m[point_distance_new(before["pos"], scan_m, min_dist)] \
            if merge else scan_m[:0]
        after = {"pos": torch.cat([before["pos"], new])}
    ref = None
    if rules.icp_knn_normals:
        ref = {"pos": after["pos"],
               "normals": knn_normals(after["pos"], rules.icp_knn_normals)}
    return pose.cpu().numpy(), after, ref
