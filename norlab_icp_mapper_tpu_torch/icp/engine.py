"""ICP engine: the replacement for libpointmatcher's ICPSequence.

The reference holds a stateful ``ICPSequence`` configured from the ``icp:``
YAML section, gives it the local map and calls ``correction = icp(input)``
per scan.  This engine reproduces that contract:

  - correspondence: the sorted-sweep radius matcher (``ops/nn_sweep.py``,
    a hand-written CUDA kernel on the card)
  - outlier rejection: per-pair weights (trimmed-distance / max-distance)
  - minimization: 6-DoF (3-DoF in 2-D) Gauss-Newton step for point-to-plane
    -- residuals, J^T J and J^T r accumulated as one matrix product, damped
    solve, SE(3) exp update -- or the identity minimizer
  - convergence: counter / differential transformation checkers

The iteration loop is a Python loop whose whole state -- the clouds, the
normal equations, the damped solve, the exp map, the running transform and
the differential checker's window -- stays on the clouds' device.  The host
keeps the iteration count and reads one boolean per iteration (the
checker's verdict); the correction comes to the host once, after the loop.
Correspondences
are re-searched every ``rematch_every`` iterations (default 3,
``NIM_TPU_REMATCH_EVERY``) and held in between.

The returned "correction" has the same meaning as lpm's: ``corrected_pose =
correction @ estimated_pose``.

Not ported yet (each raises ``NotImplementedError`` by name where a config
asks for it): PointToPointErrorMinimizer, MedianDistOutlierFilter,
SurfaceNormalOutlierFilter, BoundTransformationChecker,
readingStepDataPointsFilters, the VTKFile/Performance inspectors, and a
matcher without ``maxDist`` (it needs the brute-force k-NN kernel).
"""
from __future__ import annotations

import os
from typing import Any, Dict, NamedTuple, Optional

import numpy as np
import torch

from .. import se3
from ..draws import DrawSource
from ..points import PointBatch
from ..filters.core import FilterChain
from ..ops.nn_sweep import RefPack, presort_ref, sweep_knn


def _rematch_every() -> int:
    """GN iterations per matcher pass (correspondence-reuse period).

    Default 3: the matcher (the dominant per-iteration cost) runs every
    third iteration and the iterations between re-minimize against the held
    pairs -- true GN updates on the moved reading with fixed
    correspondences.  Set ``NIM_TPU_REMATCH_EVERY=1`` for lpm's strict
    match-every-iteration behavior.  Read when a solve starts.
    """
    return max(1, int(os.environ.get("NIM_TPU_REMATCH_EVERY", "3")))


__all__ = ["ICPEngine", "ICPResult"]


class ICPResult(NamedTuple):
    correction: torch.Tensor  # (D+1, D+1), on the CPU
    overlap: torch.Tensor  # 0-d, in [0, 1], on the reading's device
    iterations: int
    residual: torch.Tensor  # 0-d CPU tensor: final weighted RMS residual


# --------------------------------------------------------------------------
# config parsing helpers (lpm-compatible names)
# --------------------------------------------------------------------------

_DEFAULTS: Dict[str, Any] = {
    # mirrors lpm ICPChainBase::setDefault() -- used when the mapper config
    # has no `icp:` section
    "readingDataPointsFilters": [{"RandomSamplingDataPointsFilter": {"prob": 0.75}}],
    "referenceDataPointsFilters": [{"SurfaceNormalDataPointsFilter": {"knn": 10}}],
    "matcher": {"KDTreeMatcher": {"knn": 1}},
    "outlierFilters": [{"TrimmedDistOutlierFilter": {"ratio": 0.85}}],
    "errorMinimizer": "PointToPlaneErrorMinimizer",
    "transformationCheckers": [
        {"CounterTransformationChecker": {"maxIterationCount": 40}},
        {"DifferentialTransformationChecker": {
            "minDiffRotErr": 0.001, "minDiffTransErr": 0.001, "smoothLength": 4}},
    ],
    "inspector": "NullInspector",
}


def _single_key(node, what: str):
    if isinstance(node, str):
        return node, {}
    if isinstance(node, dict):
        if len(node) != 1:
            raise ValueError(f"{what}: expected single-key mapping, got {sorted(node)}")
        name, params = next(iter(node.items()))
        return name, dict(params or {})
    raise ValueError(f"{what}: invalid YAML node {node!r}")


class ICPEngine:
    """Configured, stateful scan-to-map registration (ICPSequence parity)."""

    VALID_KEYS = (
        "readingDataPointsFilters", "readingStepDataPointsFilters",
        "referenceDataPointsFilters", "matcher", "outlierFilters",
        "errorMinimizer", "transformationCheckers", "inspector", "logger",
    )

    def __init__(self, config: Optional[Dict[str, Any]] = None, dim: int = 3):
        self.dim = dim
        self._ref: Optional[PointBatch] = None
        self._ref_presorted: Optional[RefPack] = None
        self.last_overflow: Optional[torch.Tensor] = None
        self.load_config(config if config is not None else dict(_DEFAULTS))

    # ------------------------------------------------------------- config
    def set_default(self):
        self.load_config(dict(_DEFAULTS))

    def load_config(self, cfg: Dict[str, Any]):
        for k in cfg:
            if k not in self.VALID_KEYS:
                raise ValueError(
                    f"icp: unknown section '{k}'; valid: {self.VALID_KEYS}")
        self.reading_filters = FilterChain.from_yaml(
            cfg.get("readingDataPointsFilters"))
        self.reference_filters = FilterChain.from_yaml(
            cfg.get("referenceDataPointsFilters"))
        if cfg.get("readingStepDataPointsFilters"):
            raise NotImplementedError(
                "icp: readingStepDataPointsFilters are not ported yet")

        name, p = _single_key(cfg.get("matcher", {"KDTreeMatcher": {"knn": 1}}),
                              "matcher")
        if name != "KDTreeMatcher":
            raise ValueError(f"unknown matcher '{name}'")
        # epsilon is the kd-tree approximation tolerance; the sweep is exact
        self.match_knn = int(p.pop("knn", 1))
        self.match_max_dist = float(p.pop("maxDist", np.inf))
        p.pop("epsilon", None)
        p.pop("searchType", None)
        if p:
            raise ValueError(f"KDTreeMatcher: unknown params {sorted(p)}")

        self.outlier_filters = []
        for entry in cfg.get("outlierFilters") or []:
            name, p = _single_key(entry, "outlierFilters")
            if name == "TrimmedDistOutlierFilter":
                self.outlier_filters.append(("trimmed", float(p.get("ratio", 0.85))))
            elif name == "MaxDistOutlierFilter":
                self.outlier_filters.append(("maxdist", float(p["maxDist"])))
            elif name in ("MedianDistOutlierFilter",
                          "SurfaceNormalOutlierFilter"):
                raise NotImplementedError(
                    f"icp: outlier filter '{name}' is not ported yet")
            else:
                raise ValueError(f"unknown outlier filter '{name}'")

        name, p = _single_key(cfg.get("errorMinimizer", "PointToPlaneErrorMinimizer"),
                              "errorMinimizer")
        if name == "PointToPointErrorMinimizer":
            raise NotImplementedError(
                "icp: PointToPointErrorMinimizer (weighted Kabsch) is not "
                "ported yet")
        if name not in ("PointToPlaneErrorMinimizer",
                        "IdentityErrorMinimizer"):
            raise ValueError(f"unknown errorMinimizer '{name}'")
        self.minimizer = name
        self.force_2d = bool(p.pop("force2D", 0)) if p else False

        self.max_iter = 40
        self.diff_checker = None  # (minDiffTrans, minDiffRot, smoothLength)
        for entry in cfg.get("transformationCheckers") or [
                {"CounterTransformationChecker": {"maxIterationCount": 40}}]:
            name, p = _single_key(entry, "transformationCheckers")
            if name == "CounterTransformationChecker":
                self.max_iter = int(p.get("maxIterationCount", 40))
            elif name == "DifferentialTransformationChecker":
                self.diff_checker = (
                    float(p.get("minDiffTransErr", 0.001)),
                    float(p.get("minDiffRotErr", 0.001)),
                    int(p.get("smoothLength", 4)),
                )
            elif name == "BoundTransformationChecker":
                raise NotImplementedError(
                    "icp: BoundTransformationChecker is not ported yet")
            else:
                raise ValueError(f"unknown transformation checker '{name}'")

        insp = cfg.get("inspector", "NullInspector")
        iname, _ = _single_key(insp, "inspector")
        if iname in ("VTKFileInspector", "PerformanceInspector"):
            raise NotImplementedError(
                f"icp: inspector '{iname}' is not ported yet")
        if iname != "NullInspector":
            raise ValueError(f"unknown inspector '{iname}'")

    # -------------------------------------------------------------- state
    def set_map(self, ref: PointBatch, draws: Optional[DrawSource] = None):
        """lpm ``ICPSequence::setMap``: store (and reference-filter) the map.

        The reference rebuilds its kd-tree here; the sweep matcher's analog
        is the sorted presort pack, built once per map change and reused by
        every subsequent solve."""
        if len(self.reference_filters):
            ref = self.reference_filters.apply(ref, draws)
        self._ref = ref
        self._ref_presorted = None
        if np.isfinite(self.match_max_dist):
            self._ref_presorted = presort_ref(ref.positions, ref.mask)

    def has_map(self) -> bool:
        return self._ref is not None

    def clear_map(self):
        self._ref = None
        self._ref_presorted = None

    # -------------------------------------------------------------- solve
    def check_reference(self, ref: PointBatch) -> torch.Tensor:
        """The reference normals the minimizer needs (zeros if unused)."""
        if (self.minimizer == "PointToPlaneErrorMinimizer"
                and "normals" not in ref.descriptors):
            raise ValueError(
                "PointToPlaneErrorMinimizer requires 'normals' on the map; "
                "add SurfaceNormalDataPointsFilter to referenceDataPointsFilters "
                "or the mapper post filters")
        return ref.descriptors.get("normals", torch.zeros_like(ref.positions))

    def solve(self, read_pos, read_mask, ref_pos, ref_norm, ref_mask,
              ref_presorted: Optional[RefPack] = None):
        """The configured solve on raw tensors; see :func:`_icp_solve`."""
        out = _icp_solve(
            read_pos, read_mask, ref_pos, ref_norm, ref_mask, ref_presorted,
            dim=self.dim, k=self.match_knn, max_dist=self.match_max_dist,
            outlier_filters=tuple(self.outlier_filters),
            minimizer=self.minimizer, max_iter=self.max_iter,
            diff_checker=self.diff_checker, rematch_every=_rematch_every())
        self.last_overflow = out[4]
        return out[:4]

    def __call__(self, reading: PointBatch,
                 draws: Optional[DrawSource] = None) -> ICPResult:
        """Register ``reading`` (already in map frame) against the stored map.

        Returns the correction transform, like lpm's ``icp(input)``."""
        if self._ref is None:
            raise RuntimeError("ICPEngine: set_map() before calling")
        if len(self.reading_filters):
            reading = self.reading_filters.apply(reading, draws)
        ref = self._ref
        ref_normals = self.check_reference(ref)
        correction, overlap, iters, resid = self.solve(
            reading.positions, reading.mask, ref.positions, ref_normals,
            ref.mask, self._ref_presorted)
        return ICPResult(correction, overlap, iters, resid)


# --------------------------------------------------------------------------
# the solve
# --------------------------------------------------------------------------

def _rot_angle(R: torch.Tensor) -> torch.Tensor:
    d = R.shape[0]
    if d == 2:
        return torch.abs(torch.atan2(R[1, 0], R[0, 0]))
    c = torch.clamp((torch.trace(R) - 1.0) / 2.0, -1.0, 1.0)
    return torch.acos(c)


def _icp_solve(read_pos, read_mask, ref_pos, ref_norm, ref_mask,
               ref_presorted=None, *, dim, k, max_dist, outlier_filters,
               minimizer, max_iter, diff_checker, rematch_every=1):
    """One ICP registration: loop{ match -> weight -> minimize }.

    ``ref_presorted`` optionally carries ``presort_ref``'s output for
    ``ref_pos`` / ``ref_mask`` (the per-scan step caches it across scans);
    otherwise the reference is sorted ONCE here -- either way the sort stays
    out of the iteration loop.

    Returns ``(correction (D+1,D+1) on the host, overlap 0-d, iterations
    int, rms residual 0-d, overflow 0-d)``, the 0-d tensors on the reading's
    device;
    ``overflow`` sums the matcher's overflowing tiles over all passes.
    """
    f32 = torch.float32
    dev = read_pos.device
    hdim = dim + 1
    if not np.isfinite(max_dist):
        raise NotImplementedError(
            "icp: a KDTreeMatcher without maxDist is not ported yet: it "
            "needs the brute-force k-NN kernel")
    n_valid_read = torch.clamp(read_mask.to(f32).sum(), min=1.0)
    max_radius = float(max_dist)
    smooth_len = diff_checker[2] if diff_checker else 1

    # IdentityErrorMinimizer never uses the matched pairs for minimization --
    # only the overlap (fraction matched within maxDist), for which 1-NN is
    # equivalent to k-NN.  Searching k>1 would be pure waste.
    identity = minimizer == "IdentityErrorMinimizer"
    if identity:
        k = 1

    pack = (ref_presorted if ref_presorted is not None
            else presort_ref(ref_pos, ref_mask))
    # sort the reading by x ONCE and run the WHOLE solve in sweep order:
    # rigid motion keeps the order near-sorted across iterations (window
    # spans are re-measured from the moved coordinates every call), and
    # every downstream consumer -- overlap, trimmed sort, JtJ/Jtr
    # reductions -- is permutation invariant.
    q_x = torch.where(read_mask, read_pos[:, 0],
                      torch.full_like(read_pos[:, 0], 1e9))
    q_order = torch.sort(q_x, stable=True).indices
    read_pos = read_pos[q_order]
    read_mask = read_mask[q_order]
    overflow_total = torch.zeros((), dtype=torch.int64, device=dev)

    def match_and_weigh(p):
        nonlocal overflow_total
        # q_tile=1024: tight per-tile x-spans keep the true candidate range
        # inside W at map scale
        d2, idx, overflow = sweep_knn(p, ref_pos, read_mask, ref_mask, k=k,
                                      max_radius=max_radius, q_tile=1024,
                                      W=8192, presorted=pack,
                                      assume_sorted=True)
        overflow_total = overflow_total + overflow
        w = (idx >= 0).to(f32)  # [N, k]
        for kind, param in outlier_filters:
            if kind == "trimmed":
                # keep `ratio` fraction of pairs with smallest distance --
                # lpm TrimmedDistOutlierFilter
                d2_flat = torch.where(w > 0, d2,
                                      torch.full_like(d2, float("inf"))
                                      ).reshape(-1)
                n_pairs = torch.clamp(w.sum(), min=1.0)
                srt = torch.sort(d2_flat).values
                cut_idx = torch.clamp((param * n_pairs).to(torch.int64) - 1,
                                      0, d2_flat.shape[0] - 1)
                thr = srt[cut_idx]
                w = w * (d2 <= thr)
            elif kind == "maxdist":
                w = w * (d2 <= np.float32(param * param))
        safe = torch.clamp(idx, min=0)
        q = ref_pos[safe]  # [N, k, D]
        qn = ref_norm[safe]
        matched = torch.any(idx >= 0, dim=1) & read_mask
        overlap = matched.to(f32).sum() / n_valid_read
        return q, qn, w, overlap

    def minimize(p, q, qn, w):
        """Weighted point-to-plane Gauss-Newton step on the reading's
        device: normal equations, damped solve, exp map.  Returns the
        increment ``dT`` and the rms residual of the weighted pairs."""
        r = torch.einsum("nkd,nkd->nk", qn, p[:, None, :] - q)  # [N, k]
        if dim == 3:
            cx = torch.cross(p[:, None, :].expand_as(q), qn, dim=-1)
            J = torch.cat([qn, cx], dim=-1)  # [N, k, 6]
        else:
            cross2 = p[:, None, 0] * qn[..., 1] - p[:, None, 1] * qn[..., 0]
            J = torch.cat([qn, cross2[..., None]], dim=-1)  # [N, k, 3]
        Jf = J.reshape(-1, dof)
        rf = r.reshape(-1)
        wf = w.reshape(-1)
        Jw = Jf * wf[:, None]
        JtJ = Jw.T @ Jf
        Jtr = Jw.T @ rf
        wrr = torch.sum(wf * rf * rf)
        wsum = torch.clamp(torch.sum(wf), min=1e-9)
        # Levenberg-style relative damping: degenerate geometry (e.g. a
        # corridor, unconstrained along-track) leaves JtJ near-singular;
        # absolute 1e-6*I lets the pose slide meters along the null space.
        # Damping at 1e-3 of the mean eigenvalue bounds the null-space step
        # while biasing constrained directions <0.1%.
        lam = 1e-3 * torch.trace(JtJ) / dof + 1e-6
        JtJ = JtJ + lam * eye_dof
        # solve_ex: the damped matrix is never singular, and the error
        # check of linalg.solve would be a second host read per iteration
        dx = -torch.linalg.solve_ex(JtJ, Jtr).result
        dT = se3.exp_se3(dx) if dim == 3 else se3.exp_se2(dx)
        return dT, torch.sqrt(wrr / wsum)

    # The whole loop state lives on the reading's device.  The host keeps
    # the iteration count and reads one boolean per iteration (the
    # differential checker's verdict); the correction comes to the host
    # once, after the loop.
    eye_h = torch.eye(hdim, dtype=f32, device=dev)
    dof = 6 if dim == 3 else 3
    eye_dof = torch.eye(dof, dtype=f32, device=dev)
    T = eye_h
    it = 0
    done = False
    overlap = torch.zeros((), dtype=f32, device=dev)
    rms = torch.zeros((), dtype=f32, device=dev)
    hist = torch.full((smooth_len, 2), float("inf"), dtype=f32, device=dev)
    use_reuse = rematch_every > 1 and not identity
    corr = None
    while it < max_iter and not done:
        p = se3.apply_points(T, read_pos)  # [N, D]
        if corr is None or not use_reuse or it % rematch_every == 0:
            corr = match_and_weigh(p)
        q, qn, w, overlap = corr
        if identity:
            dT = eye_h
        else:
            dT, rms = minimize(p, q, qn, w)
        T = dT @ T
        done = identity
        # differential checker: rolling window of increment magnitudes
        dtrans = torch.linalg.norm(dT[:dim, dim])
        drot = _rot_angle(dT[:dim, :dim])
        hist = torch.roll(hist, 1, dims=0)
        hist[0] = torch.stack([dtrans, drot])
        if (diff_checker is not None and not done
                and it + 1 >= smooth_len):
            min_t, min_r, _ = diff_checker
            means = hist.mean(dim=0)
            # the one host read of the iteration
            done = bool((means[0] < min_t) & (means[1] < min_r))
        it += 1
    T = T.cpu()
    return T, overlap, it, rms, overflow_total
