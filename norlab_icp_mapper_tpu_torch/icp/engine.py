"""ICP engine: the replacement for libpointmatcher's ICPSequence.

The reference holds a stateful ``ICPSequence`` configured from the ``icp:``
YAML section, gives it the local map and calls ``correction = icp(input)``
per scan.  This engine reproduces that contract:

  - correspondence: with ``maxDist`` the sorted-sweep radius matcher
    (``ops/nn_sweep.py``), without it the brute-force k-NN (``ops/nn.py``);
    both are hand-written CUDA kernels on the card
  - outlier rejection: per-pair weights (trimmed-distance / max-distance /
    median-distance / surface-normal angle)
  - minimization: 6-DoF (3-DoF in 2-D) Gauss-Newton step for point-to-plane
    -- residuals, J^T J and J^T r accumulated as one matrix product, damped
    solve, SE(3) exp update --, closed-form weighted SVD (Kabsch) for
    point-to-point, or the identity minimizer
  - convergence: counter / differential / bound transformation checkers

The iteration loop is a Python loop with one host read per iteration.  For
point-to-plane its whole state -- the clouds, the normal equations, the
damped solve, the exp map, the running transform and the checkers' window
-- stays on the clouds' device, and the read is one boolean (the checkers'
verdict).  For point-to-point the read is the packed moments of the
weighted pairs (17 floats in 3-D): the DxD SVD runs on the host (LAPACK on
nine numbers, where the card would launch a library solver per iteration),
and the running transform and the checkers then live on the host too and
need no second read.  The
correction comes to the host once, after the loop.  Correspondences are
re-searched every ``rematch_every`` iterations (default 3,
``NIM_TPU_REMATCH_EVERY``) and held in between.

The returned "correction" has the same meaning as lpm's: ``corrected_pose =
correction @ estimated_pose``.

Not ported yet (each raises ``NotImplementedError`` by name where a config
asks for it): the VTKFile/Performance inspectors.
"""
from __future__ import annotations

import os
from typing import Any, Dict, NamedTuple, Optional, Union

import numpy as np
import torch

from .. import se3
from ..draws import DrawSource
from ..points import PointBatch
from ..filters.core import FilterChain
from ..ops.nn import KnnPack, knn, pack_refs
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
        # the matcher's view of the reference, built once per map change:
        # the sorted pack of the sweep, or the packed references of the
        # brute-force search when the matcher has no maxDist
        self._ref_pack: Union[RefPack, KnnPack, None] = None
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
        # applied to the (moved) reading at every matcher pass -- lpm
        # semantics; only mask edits take effect, which is what lpm's step
        # filters (random sampling etc.) do anyway
        self.reading_step_filters = FilterChain.from_yaml(
            cfg.get("readingStepDataPointsFilters"))

        name, p = _single_key(cfg.get("matcher", {"KDTreeMatcher": {"knn": 1}}),
                              "matcher")
        if name != "KDTreeMatcher":
            raise ValueError(f"unknown matcher '{name}'")
        # epsilon is the kd-tree approximation tolerance; both searches here
        # are exact
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
            elif name == "MedianDistOutlierFilter":
                self.outlier_filters.append(("median", float(p.get("factor", 3.0))))
            elif name == "SurfaceNormalOutlierFilter":
                self.outlier_filters.append(("normal", float(p.get("maxAngle", 1.57))))
            else:
                raise ValueError(f"unknown outlier filter '{name}'")

        name, p = _single_key(cfg.get("errorMinimizer", "PointToPlaneErrorMinimizer"),
                              "errorMinimizer")
        if name not in ("PointToPlaneErrorMinimizer", "PointToPointErrorMinimizer",
                        "IdentityErrorMinimizer"):
            raise ValueError(f"unknown errorMinimizer '{name}'")
        self.minimizer = name
        self.force_2d = bool(p.pop("force2D", 0)) if p else False

        self.max_iter = 40
        self.diff_checker = None  # (minDiffTrans, minDiffRot, smoothLength)
        self.bound_checker = None  # (maxRotationNorm, maxTranslationNorm)
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
                self.bound_checker = (
                    float(p.get("maxRotationNorm", 1.0)),
                    float(p.get("maxTranslationNorm", 1.0)),
                )
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

        The reference rebuilds its kd-tree here; the analog is the
        matcher's pack (:meth:`build_ref_pack`), built once per map change
        and reused by every subsequent solve."""
        if len(self.reference_filters):
            ref = self.reference_filters.apply(ref, draws)
        self._ref = ref
        self._ref_pack = self.build_ref_pack(ref)

    def build_ref_pack(self, ref: PointBatch) -> Union[RefPack, KnnPack]:
        """What the configured matcher prepares once per change of the
        reference: with ``maxDist`` the x-sorted pack of the sweep, without
        it the valid references packed to the front for the brute-force
        search (no sort by x, no window)."""
        if np.isfinite(self.match_max_dist):
            return presort_ref(ref.positions, ref.mask)
        return pack_refs(ref.positions, ref.mask)

    def grow_map(self, local: PointBatch) -> None:
        """The map buffer was padded to a larger capacity (``local`` is the
        padded cloud, same points): pad the reference alike, without running
        the reference filters again, and rebuild the matcher's pack."""
        if len(self.reference_filters):
            self._ref = self._ref.pad_to(local.capacity)
        else:
            self._ref = local
        self._ref_pack = self.build_ref_pack(self._ref)

    def has_map(self) -> bool:
        return self._ref is not None

    def clear_map(self):
        self._ref = None
        self._ref_pack = None

    # -------------------------------------------------------------- solve
    def check_reference(self, ref: PointBatch) -> torch.Tensor:
        """The reference normals the minimizer or the surface-normal outlier
        filter needs (zeros if unused)."""
        need_normals = self.minimizer == "PointToPlaneErrorMinimizer" or any(
            kind == "normal" for kind, _ in self.outlier_filters)
        if need_normals and "normals" not in ref.descriptors:
            raise ValueError(
                "PointToPlaneErrorMinimizer requires 'normals' on the map; "
                "add SurfaceNormalDataPointsFilter to referenceDataPointsFilters "
                "or the mapper post filters")
        return ref.descriptors.get("normals", torch.zeros_like(ref.positions))

    def solve(self, read_pos, read_mask, ref_pos, ref_norm, ref_mask,
              ref_pack: Union[RefPack, KnnPack],
              draws: Optional[DrawSource] = None):
        """The configured solve on raw tensors; see :func:`_icp_solve`.
        ``ref_pack`` is :meth:`build_ref_pack` of the reference; ``draws``
        feeds the step filters, if any."""
        out = _icp_solve(
            read_pos, read_mask, ref_pos, ref_norm, ref_mask, ref_pack,
            dim=self.dim, k=self.match_knn, max_dist=self.match_max_dist,
            outlier_filters=tuple(self.outlier_filters),
            minimizer=self.minimizer, max_iter=self.max_iter,
            diff_checker=self.diff_checker, bound_checker=self.bound_checker,
            step_filters=(self.reading_step_filters
                          if len(self.reading_step_filters) else None),
            draws=draws, rematch_every=_rematch_every())
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
            ref.mask, self._ref_pack, draws)
        if self.bound_checker is not None:
            # lpm's BoundTransformationChecker THROWS when the accumulated
            # transform exceeds the bound (registration aborts, the caller
            # sees the exception).  The loop stops iterating at the bound;
            # this check on the host's copy of the correction reproduces the
            # throw.  (The per-scan step cannot throw mid-pipeline; configs
            # with a bound checker take this stepwise path, see the Mapper.)
            max_rot, max_trans = self.bound_checker
            T_h = correction.numpy()
            d = self.dim
            if (_rot_angle_np(T_h[:d, :d]) > max_rot
                    or float(np.linalg.norm(T_h[:d, d])) > max_trans):
                raise RuntimeError(
                    "BoundTransformationChecker: transformation beyond bound "
                    f"(maxRotationNorm={max_rot}, maxTranslationNorm="
                    f"{max_trans}) -- lpm aborts registration here")
        return ICPResult(correction, overlap, iters, resid)


# --------------------------------------------------------------------------
# the solve
# --------------------------------------------------------------------------

def _rot_angle_np(R: np.ndarray) -> float:
    if R.shape[0] == 2:
        return abs(float(np.arctan2(R[1, 0], R[0, 0])))
    return float(np.arccos(np.clip((np.trace(R) - 1.0) / 2.0, -1.0, 1.0)))


def _rot_angle(R: torch.Tensor) -> torch.Tensor:
    d = R.shape[0]
    if d == 2:
        return torch.abs(torch.atan2(R[1, 0], R[0, 0]))
    c = torch.clamp((torch.trace(R) - 1.0) / 2.0, -1.0, 1.0)
    return torch.acos(c)


def _icp_solve(read_pos, read_mask, ref_pos, ref_norm, ref_mask,
               ref_pack, *, dim, k, max_dist, outlier_filters,
               minimizer, max_iter, diff_checker, bound_checker=None,
               step_filters=None, draws=None, rematch_every=1):
    """One ICP registration: loop{ match -> weight -> minimize }.

    ``ref_pack`` is the matcher's pack for ``ref_pos`` / ``ref_mask``
    (``ICPEngine.build_ref_pack``, which picks its kind; built once per
    change of the reference and cached across scans, so it stays out of the
    iteration loop).  ``step_filters`` (a ``FilterChain``) edits
    the reading's mask at every matcher pass, drawing from ``draws``.

    Returns ``(correction (D+1,D+1) on the host, overlap 0-d, iterations
    int, rms residual 0-d, overflow 0-d)``, overlap and overflow on the
    reading's device;
    ``overflow`` sums the sweep matcher's overflowing tiles over all passes
    (it stays 0 for a matcher without ``maxDist``).
    """
    f32 = torch.float32
    dev = read_pos.device
    hdim = dim + 1
    n_valid_read = torch.clamp(read_mask.to(f32).sum(), min=1.0)
    bounded = bool(np.isfinite(max_dist))
    smooth_len = diff_checker[2] if diff_checker else 1

    # IdentityErrorMinimizer never uses the matched pairs for minimization --
    # only the overlap (fraction matched within maxDist), for which 1-NN is
    # equivalent to k-NN.  Searching k>1 would be pure waste.
    identity = minimizer == "IdentityErrorMinimizer"
    p2p = minimizer == "PointToPointErrorMinimizer"
    if identity:
        k = 1

    if bounded:
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
    # (no radius: every pair is examined, so nothing is sorted)
    overflow_total = torch.zeros((), dtype=torch.int64, device=dev)

    def match_and_weigh(p):
        nonlocal overflow_total
        cur_mask = read_mask
        if step_filters is not None:
            # lpm readingStepDataPointsFilters: re-filter a fresh copy of
            # the (moved) reading at every pass; mask-only effects here
            stepped = step_filters._apply_impl(
                PointBatch(p, read_mask, {}), draws)
            p, cur_mask = stepped.positions, stepped.mask
        if bounded:
            # q_tile=1024: tight per-tile x-spans keep the true candidate
            # range inside W at map scale
            d2, idx, overflow = sweep_knn(p, ref_pos, cur_mask, ref_mask,
                                          k=k, max_radius=float(max_dist),
                                          q_tile=1024, W=8192,
                                          presorted=ref_pack,
                                          assume_sorted=True)
            overflow_total = overflow_total + overflow
        else:
            d2, idx = knn(p, ref_pos, cur_mask, ref_mask, k=k, pack=ref_pack)
        w = (idx >= 0).to(f32)  # [N, k]
        safe = torch.clamp(idx, min=0)
        qn = ref_norm[safe]  # [N, k, D]
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
            elif kind == "median":
                # lpm MedianDistOutlierFilter: the median of the weighted
                # pairs' d2 is the mean of the two middle values when their
                # count is even (``torch.nanmedian`` would take the lower)
                d2_flat = torch.where(w > 0, d2,
                                      torch.full_like(d2, float("inf"))
                                      ).reshape(-1)
                n_pairs = (w > 0).sum()
                srt = torch.sort(d2_flat).values
                last = d2_flat.shape[0] - 1
                lo = torch.clamp((n_pairs - 1) // 2, 0, last)
                hi = torch.clamp(n_pairs // 2, 0, last)
                med = 0.5 * srt[lo] + 0.5 * srt[hi]
                w = w * (d2 <= float(np.float32(param * param)) * med)
            elif kind == "normal":
                # angle between reading ray and ref normal below maxAngle
                pdir = p / torch.clamp(
                    torch.linalg.norm(p, dim=1, keepdim=True), min=1e-9)
                cosang = torch.abs(torch.einsum("nd,nkd->nk", pdir, qn))
                w = w * (torch.acos(torch.clamp(cosang, 0, 1))
                         <= float(np.float32(param)))
        q = ref_pos[safe]  # [N, k, D]
        matched = torch.any(idx >= 0, dim=1) & cur_mask
        overlap = matched.to(f32).sum() / n_valid_read
        return q, qn, w, overlap

    def minimize_plane(p, q, qn, w):
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

    def minimize_point(p, q, w):
        """Weighted Kabsch: the moments of the weighted pairs are reduced
        on the reading's device and come to the host packed in one tensor
        (the one host read of the iteration); the DxD SVD, the rotation and
        the increment are computed there.  Returns ``dT`` and the rms
        residual as host tensors."""
        wk = w[..., None]
        wsum = torch.clamp(torch.sum(w), min=1e-9)
        mu_p = torch.sum(wk * p[:, None, :], dim=(0, 1)) / wsum
        mu_q = torch.sum(wk * q, dim=(0, 1)) / wsum
        P = (p[:, None, :] - mu_p) * wk
        Q = q - mu_q
        H = torch.einsum("nkd,nke->de", P, Q)  # [D, D]
        diff = p[:, None, :] - q
        wdd = torch.sum(w * torch.sum(diff * diff, -1))
        packed = torch.cat([H.reshape(-1), mu_p, mu_q,
                            wsum[None], wdd[None]]).cpu()
        H = packed[:dim * dim].reshape(dim, dim)
        mu_p = packed[dim * dim:dim * dim + dim]
        mu_q = packed[dim * dim + dim:dim * dim + 2 * dim]
        U, _, Vt = torch.linalg.svd(H)
        det = torch.linalg.det(Vt.T @ U.T)
        S = torch.diag(torch.cat([torch.ones(dim - 1, dtype=f32), det[None]]))
        R = Vt.T @ S @ U.T
        dT = torch.eye(hdim, dtype=f32)
        dT[:dim, :dim] = R
        dT[:dim, dim] = mu_q - R @ mu_p
        return dT, torch.sqrt(packed[-1] / packed[-2])

    # Where the small state of the loop lives: on the reading's device,
    # except for point-to-point, whose increment is computed on the host.
    # The host keeps the iteration count and reads once per iteration: the
    # checkers' verdict (one boolean), or for point-to-point the packed
    # moments (the checkers then run on host tensors and read nothing).
    sdev = torch.device("cpu") if p2p else dev
    eye_h = torch.eye(hdim, dtype=f32, device=sdev)
    dof = 6 if dim == 3 else 3
    eye_dof = torch.eye(dof, dtype=f32, device=dev)
    T = eye_h
    it = 0
    done = False
    overlap = torch.zeros((), dtype=f32, device=dev)
    rms = torch.zeros((), dtype=f32, device=sdev)
    hist = torch.full((smooth_len, 2), float("inf"), dtype=f32, device=sdev)
    use_reuse = rematch_every > 1 and not identity
    corr = None
    while it < max_iter and not done:
        p = se3.apply_points(T, read_pos)  # [N, D]
        if corr is None or not use_reuse or it % rematch_every == 0:
            corr = match_and_weigh(p)
        q, qn, w, overlap = corr
        if identity:
            dT = eye_h
        elif p2p:
            dT, rms = minimize_point(p, q, w)
        else:
            dT, rms = minimize_plane(p, q, qn, w)
        T = dT @ T
        done = identity
        # differential checker: rolling window of increment magnitudes
        dtrans = torch.linalg.norm(dT[:dim, dim])
        drot = _rot_angle(dT[:dim, :dim])
        hist = torch.roll(hist, 1, dims=0)
        hist[0] = torch.stack([dtrans, drot])
        verdict = None
        if diff_checker is not None and it + 1 >= smooth_len:
            min_t, min_r, _ = diff_checker
            means = hist.mean(dim=0)
            verdict = (means[0] < min_t) & (means[1] < min_r)
        if bound_checker is not None:
            # the bound is on the total transform so far; the loop stops
            # here and the engine's caller raises (see ICPEngine.__call__)
            max_rot, max_trans = bound_checker
            beyond = ((_rot_angle(T[:dim, :dim]) > max_rot)
                      | (torch.linalg.norm(T[:dim, dim]) > max_trans))
            verdict = beyond if verdict is None else verdict | beyond
        if verdict is not None and not done:
            done = bool(verdict)  # the one host read (none if on the host)
        it += 1
    T = T.cpu()
    return T, overlap, it, rms, overflow_total
