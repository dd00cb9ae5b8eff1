"""Plain scan-to-map ICP with a point-to-plane minimizer, the chain the
mapper configurations name (libpointmatcher's ICP): the reading filtered
once, then per iteration a k-NN match within ``maxDist``, a trimmed
outlier filter, one damped Gauss-Newton step on the point-to-plane
residuals, the counter and differential checkers."""
from __future__ import annotations

from dataclasses import dataclass

import torch

from .nn import knn, mm


@dataclass(frozen=True)
class IcpConfig:
    keep_prob: float  # RandomSamplingDataPointsFilter on the reading
    knn: int
    max_dist: float
    trim_ratio: float
    max_iter: int
    min_diff_trans: float
    min_diff_rot: float
    smooth_length: int

    @staticmethod
    def from_mapper_config(cfg) -> "IcpConfig":
        """From a mapper YAML tree (``None``: libpointmatcher's defaults)."""
        icp = (cfg or {}).get("icp") or {
            "readingDataPointsFilters": [
                {"RandomSamplingDataPointsFilter": {"prob": 0.75}}],
            "matcher": {"KDTreeMatcher": {"knn": 1}},
            "outlierFilters": [{"TrimmedDistOutlierFilter": {"ratio": 0.85}}],
            "transformationCheckers": [
                {"CounterTransformationChecker": {"maxIterationCount": 40}},
                {"DifferentialTransformationChecker": {
                    "minDiffRotErr": 0.001, "minDiffTransErr": 0.001,
                    "smoothLength": 4}}]}
        prob = 1.0
        for f in icp.get("readingDataPointsFilters") or []:
            (name, p), = f.items()
            if name != "RandomSamplingDataPointsFilter":
                raise ValueError(f"reference ICP: no reading filter {name}")
            prob *= float(p.get("prob", 0.75))
        (mname, mp), = icp["matcher"].items()
        (oname, op), = icp["outlierFilters"][0].items()
        if (mname, oname) != ("KDTreeMatcher", "TrimmedDistOutlierFilter"):
            raise ValueError("reference ICP: KDTreeMatcher and "
                             "TrimmedDistOutlierFilter only")
        max_iter, diff = 40, (0.001, 0.001, 4)
        for c in icp["transformationCheckers"]:
            (cname, cp), = c.items()
            if cname == "CounterTransformationChecker":
                max_iter = int(cp.get("maxIterationCount", 40))
            elif cname == "DifferentialTransformationChecker":
                diff = (float(cp.get("minDiffTransErr", 0.001)),
                        float(cp.get("minDiffRotErr", 0.001)),
                        int(cp.get("smoothLength", 4)))
        return IcpConfig(prob, int(mp.get("knn", 1)),
                         float(mp.get("maxDist", float("inf"))),
                         float(op.get("ratio", 0.85)), max_iter, *diff)


def transform(T: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    return mm(p, T[:3, :3].T) + T[:3, 3]


def _skew(w: torch.Tensor) -> torch.Tensor:
    z = torch.zeros((), dtype=w.dtype, device=w.device)
    return torch.stack([torch.stack([z, -w[2], w[1]]),
                        torch.stack([w[2], z, -w[0]]),
                        torch.stack([-w[1], w[0], z])])


def exp_se3(xi: torch.Tensor) -> torch.Tensor:
    """4x4 of the twist ``[v, w]`` (float64)."""
    v, w = xi[:3], xi[3:]
    th = torch.linalg.norm(w)
    W = _skew(w)
    eye = torch.eye(3, dtype=xi.dtype, device=xi.device)
    if float(th) < 1e-9:
        R, V = eye + W, eye + 0.5 * W
    else:
        a = torch.sin(th) / th
        b = (1 - torch.cos(th)) / th ** 2
        c = (1 - a) / th ** 2
        R = eye + a * W + b * W @ W
        V = eye + b * W + c * W @ W
    T = torch.eye(4, dtype=xi.dtype, device=xi.device)
    T[:3, :3] = R
    T[:3, 3] = V @ v
    return T


def rotation_angle(R: torch.Tensor) -> float:
    """The angle of a rotation matrix, from its skew part and its trace
    (well conditioned near 0, unlike the arccos of the trace alone)."""
    R = R.double()
    s = 0.5 * torch.linalg.norm(torch.stack([R[2, 1] - R[1, 2],
                                             R[0, 2] - R[2, 0],
                                             R[1, 0] - R[0, 1]]))
    return float(torch.atan2(s, (torch.trace(R) - 1) / 2))


def register(scan: torch.Tensor, prior: torch.Tensor, ref: torch.Tensor,
             ref_normals: torch.Tensor, cfg: IcpConfig,
             generator: torch.Generator) -> torch.Tensor:
    """The corrected pose (f32 4x4) of ``scan`` (sensor frame, valid rows)
    registered from ``prior`` against ``ref`` with its normals."""
    reading = transform(prior, scan)
    if cfg.keep_prob < 1.0:
        u = torch.rand(reading.shape[0], generator=generator,
                       device=reading.device)
        reading = reading[u < cfg.keep_prob]
    T = torch.eye(4, dtype=torch.float64, device=scan.device)
    hist = []
    for _ in range(cfg.max_iter):
        p = transform(T.float(), reading)
        d2, idx = knn(p, ref, cfg.knn, cfg.max_dist)
        w = idx >= 0
        n_pairs = int(w.sum())
        if n_pairs == 0:
            break
        srt = torch.sort(d2[w]).values
        cut = srt[max(int(cfg.trim_ratio * n_pairs) - 1, 0)]
        w = w & (d2 <= cut)
        pi = p[:, None, :].expand(-1, cfg.knn, -1)[w].double()
        q = ref[idx[w]].double()
        n = ref_normals[idx[w]].double()
        r = ((pi - q) * n).sum(1)
        J = torch.cat([n, torch.cross(pi, n, dim=1)], dim=1)
        JtJ = J.T @ J
        lam = 1e-3 * torch.trace(JtJ) / 6 + 1e-6
        dx = -torch.linalg.solve(
            JtJ + lam * torch.eye(6, dtype=JtJ.dtype, device=JtJ.device),
            J.T @ r)
        dT = exp_se3(dx)
        T = dT @ T
        hist.append((float(torch.linalg.norm(dT[:3, 3])),
                     rotation_angle(dT[:3, :3])))
        last = hist[-cfg.smooth_length:]
        if (len(last) == cfg.smooth_length
                and sum(h[0] for h in last) / len(last) < cfg.min_diff_trans
                and sum(h[1] for h in last) / len(last) < cfg.min_diff_rot):
            break
    return (T @ prior.double()).float()
