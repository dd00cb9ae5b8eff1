"""ICP engine: the replacement for libpointmatcher's ICPSequence.

The reference holds a stateful ``ICPSequence`` configured from the ``icp:``
YAML section, gives it the local map and calls ``correction = icp(input)``
per scan.  This engine reproduces that contract:

  - correspondence: with ``maxDist`` the sorted-sweep radius matcher
    (``ops/nn_sweep.py``); without it, on the card, the cell-grid 1-NN
    (``ops/nn_grid.py``) at k = 1 and the brute-force k-NN (``ops/nn.py``)
    at k > 1, and ``knn_plain`` on the CPU; all exact, the kernels written
    by hand
  - outlier rejection: per-pair weights (trimmed-distance / max-distance /
    median-distance / surface-normal angle)
  - minimization: 6-DoF (3-DoF in 2-D) Gauss-Newton step for point-to-plane
    -- residuals, J^T J and J^T r accumulated as one matrix product, damped
    solve, SE(3) exp update --, closed-form weighted SVD (Kabsch) for
    point-to-point, or the identity minimizer
  - convergence: counter / differential / bound transformation checkers

The iteration loop is the JAX package's ``lax.while_loop``: its state
``(T, it, done, overlap, rms, hist)`` is a set of tensors and one iteration
is a function of them (:class:`_Loop`), masked so that an iteration after
the stop changes no bit.  On a CUDA device every solve -- any minimizer,
with or without reading step filters -- is one CUDA graph
(:class:`_SolveGraph`): the initial state, then a WHILE node
(``ops/graph_loop.py``) whose body is ``rematch_every`` iterations; the
host reads nothing until the caller wants the result.  Each iteration
commits its state in one ``loop_commit``, which on the body's last
iteration also sets the node's condition.  Point-to-point goes from the
pairs to its rigid increment in one ``p2p_step`` (``ops/kabsch.py``); the
step filters draw keyed uniforms (``draws.KeyedDraws``, ``ops/philox.py``)
counted by the loop's device ``it``.  Graphs are cached per configuration, step chain,
seed and capacities.  On the CPU the same iteration runs under a Python
loop that reads ``done`` before each iteration.  Correspondences are
re-searched every ``rematch_every`` iterations (default 3,
``NIM_TPU_REMATCH_EVERY``) and held in between.

Step filters draw on the moved reading's original rows (the sweep sorts it
by x once per solve), so a draw lands on the same point with or without the
sort, as in the JAX package's CPU solve.  A row-local chain
(``FilterChain.row_local``: box, distance and NaN gates, RandomSampling)
runs on the reading in the solve's order and is handed the sort as
``rows``: one ``philox_keep`` launch for a RandomSampling step filter, no
gather.  Any other chain (voxel and octree decimations, MaxPointCount) sees
the reading permuted back to its original order, and its mask and positions
are permuted forward again.

The returned "correction" has the same meaning as lpm's: ``corrected_pose =
correction @ estimated_pose``.

Inspectors (``inspector: VTKFileInspector`` / ``PerformanceInspector``)
run the registration one iteration per solve and record every iteration in
a ``utils.tracing.IterationInspector`` (the VTK one also dumps the moved
reading): lpm's inspector contract, with its cost, a host read per
iteration.  The sweep matcher's overflow count is reported to
``utils.tracing.record_overflow`` as ``icp_matcher_sweep``; the grid
matcher's valid queries and fallback queries over a solve come back as
``ICPEngine.last_nn_grid`` (i64[2] on the card, nothing read).
"""
from __future__ import annotations

import collections
import os
from typing import Any, Dict, NamedTuple, Optional, Union

import numpy as np
import torch

from .. import se3
from ..draws import DrawSource
from ..ops.kabsch import kabsch, p2p_step
from ..ops.philox import philox_keep, philox_uniform
from ..points import PointBatch
from ..filters.core import FilterChain
from ..ops import graph_loop
from ..ops.nn import KnnPack, knn, pack_refs
from ..ops.nn_grid import (GridPack, build_grid_pack, knn_grid,
                           matcher_pack_kind)
from ..ops.nn_sweep import RefPack, presort_ref, sweep_knn
from ..utils.tracing import IterationInspector, record_overflow


def _rematch_every() -> int:
    """GN iterations per matcher pass (correspondence-reuse period).

    Default 3: the matcher (the dominant per-iteration cost) runs every
    third iteration and the iterations between re-minimize against the held
    pairs -- true GN updates on the moved reading with fixed
    correspondences.  Set ``NIM_TPU_REMATCH_EVERY=1`` for lpm's strict
    match-every-iteration behavior.  Read when a solve starts.
    """
    return max(1, int(os.environ.get("NIM_TPU_REMATCH_EVERY", "3")))


__all__ = ["ICPEngine", "ICPResult", "SolveOutput", "GraphReplay"]

_GRAPHS_KEPT = 4  # solve graphs an engine keeps (capacities change rarely)


class ICPResult(NamedTuple):
    correction: torch.Tensor  # (D+1, D+1), on the CPU
    overlap: torch.Tensor  # 0-d, in [0, 1], on the reading's device
    iterations: int
    residual: torch.Tensor  # 0-d, final weighted RMS residual


class SolveOutput(NamedTuple):
    """What :meth:`ICPEngine.solve` returns, every tensor on the reading's
    device and nothing read on the host."""
    correction: torch.Tensor  # (D+1, D+1)
    overlap: torch.Tensor  # 0-d
    iterations: torch.Tensor  # 0-d int32
    residual: torch.Tensor  # 0-d


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
        # (reference, the matcher's view of it): the pack is built once per
        # map change -- the sorted pack of the sweep, or the packed
        # references of the brute-force search when the matcher has no
        # maxDist.  One attribute, so that a solve never pairs a reference
        # with another one's pack while a map-update thread installs both.
        self._ref_state: tuple = (None, None)
        self.last_overflow: Optional[torch.Tensor] = None
        # the grid matcher's (valid queries, fallback queries) of the last
        # solve, i64[2] on the card (None for another matcher)
        self.last_nn_grid: Optional[torch.Tensor] = None
        # the launches of the last solve's graph replay, to be counted once
        # its iterations are known (None: the wrappers counted them)
        self.last_replay: Optional["GraphReplay"] = None
        self._graphs: "collections.OrderedDict" = collections.OrderedDict()
        self.graph_captures = 0
        # the step filters' draws when the caller passes none, and the
        # solve index the last keyed solve drew with
        self._draws = DrawSource(0)
        self.last_solve_index = 0
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
        iname, ip = _single_key(insp, "inspector")
        self.inspector: Optional[IterationInspector] = None
        if iname == "VTKFileInspector":
            # the engine switches to the inspected solve (one iteration per
            # solve, the moved reading dumped after each): lpm's tradeoff
            self.inspector = IterationInspector(
                dump_dir=str(ip.get("baseFileName", "icp_inspect")))
        elif iname == "PerformanceInspector":
            self.inspector = IterationInspector(dump_dir=None)
        elif iname != "NullInspector":
            raise ValueError(f"unknown inspector '{iname}'")

    # -------------------------------------------------------------- state
    @property
    def _ref(self) -> Optional[PointBatch]:
        return self._ref_state[0]

    @_ref.setter
    def _ref(self, ref: Optional[PointBatch]) -> None:
        self._ref_state = (ref, self._ref_state[1])

    @property
    def _ref_pack(self) -> Union[RefPack, KnnPack, GridPack, None]:
        return self._ref_state[1]

    @_ref_pack.setter
    def _ref_pack(self, pack) -> None:
        self._ref_state = (self._ref_state[0], pack)

    def set_map(self, ref: PointBatch, draws: Optional[DrawSource] = None):
        """lpm ``ICPSequence::setMap``: store (and reference-filter) the map.

        The reference rebuilds its kd-tree here; the analog is the
        matcher's pack (:meth:`build_ref_pack`), built once per map change
        and reused by every subsequent solve."""
        if len(self.reference_filters):
            ref = self.reference_filters.apply(ref, draws)
        self._ref_state = (ref, self.build_ref_pack(ref))

    def build_ref_pack(self, ref: PointBatch
                       ) -> Union[RefPack, KnnPack, GridPack]:
        """What the configured matcher prepares once per change of the
        reference (``nn_grid.matcher_pack_kind``): with ``maxDist`` the
        x-sorted pack of the sweep; without it, at k = 1 on the card, the
        cell grid of ``nn_grid``, and otherwise the valid references packed
        to the front for the brute-force search."""
        kind = matcher_pack_kind(self.match_max_dist, self.match_knn,
                                 ref.positions.device)
        if kind == "sweep":
            return presort_ref(ref.positions, ref.mask)
        if kind == "grid":
            return build_grid_pack(ref.positions, ref.mask)
        return pack_refs(ref.positions, ref.mask)

    def grow_map(self, local: PointBatch) -> None:
        """The map buffer was padded to a larger capacity (``local`` is the
        padded cloud, same points): pad the reference alike, without running
        the reference filters again, and rebuild the matcher's pack."""
        ref = (self._ref.pad_to(local.capacity)
               if len(self.reference_filters) else local)
        self._ref_state = (ref, self.build_ref_pack(ref))

    def has_map(self) -> bool:
        return self._ref is not None

    def clear_map(self):
        self._ref_state = (None, None)

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

    def _step(self, draws: Optional[DrawSource]):
        """``(step chain or None, draws, solve index)`` of a solve: the
        keyed draws take the next solve index of ``draws`` (the engine's own
        source when the caller gives none)."""
        if not len(self.reading_step_filters):
            return None, draws, 0
        draws = draws if draws is not None else self._draws
        index = draws.next_solve() if draws.source is None else 0
        self.last_solve_index = index
        return self.reading_step_filters, draws, index

    def solve(self, read_pos, read_mask, ref_pos, ref_norm, ref_mask,
              ref_pack: Union[RefPack, KnnPack, GridPack],
              draws: Optional[DrawSource] = None) -> SolveOutput:
        """The configured solve on raw tensors.  ``ref_pack`` is
        :meth:`build_ref_pack` of the reference; ``draws`` feeds the step
        filters, if any (keyed by its seed and its next solve index; a
        caller-supplied ``source`` is asked once per pass, on the CPU
        only).  On a CUDA device it is one replay of a cached graph
        (:class:`_SolveGraph`); on the CPU the Python loop."""
        cfg = self.solve_config()
        args = (read_pos, read_mask, ref_pos, ref_norm, ref_mask, ref_pack)
        step, draws, index = self._step(draws)
        if read_pos.is_cuda:
            _refuse_source_on_card(step, draws, read_pos.device)
            graph = self._graph(cfg, args, step, draws)
            out = graph.run(*args, solve_index=index)
            self.last_replay = graph.replay
            self.last_nn_grid = graph.last_nn_grid
        else:
            loop = _loop(*args, step_filters=step, draws=draws,
                         solve_index=index, **cfg)
            out = loop.run()
            self.last_replay = None
            self.last_nn_grid = loop.nn_grid
        self.last_overflow = out[4]
        if np.isfinite(self.match_max_dist):
            record_overflow("icp_matcher_sweep", out[4])
        return SolveOutput(*out[:4])

    def solve_config(self) -> Dict[str, Any]:
        """The keyword arguments of :func:`_icp_solve` for this
        configuration (``rematch_every`` read from the environment now)."""
        return dict(
            dim=self.dim, k=self.match_knn, max_dist=self.match_max_dist,
            outlier_filters=tuple(self.outlier_filters),
            minimizer=self.minimizer, max_iter=self.max_iter,
            diff_checker=self.diff_checker, bound_checker=self.bound_checker,
            rematch_every=_rematch_every())

    def _graph(self, cfg, args, step=None, draws=None) -> "_SolveGraph":
        """The cached solve graph for this configuration, step chain, seed
        and shapes, captured on first use."""
        step_key = None if step is None else (draws.seed, tuple(
            (getattr(f, "NAME", type(f).__name__),
             repr(sorted(f.params.items()))) for f in step.filters))
        key = (tuple(sorted(cfg.items())),
               tuple((tuple(t.shape), t.dtype) for t in args[:5]),
               type(args[5]).__name__, args[0].device, step_key)
        graph = self._graphs.pop(key, None)
        if graph is None:
            graph = _SolveGraph(cfg, *args, step_filters=step, draws=draws)
            self.graph_captures += 1
            while len(self._graphs) >= _GRAPHS_KEPT:
                self._graphs.popitem(last=False)[1].close()
        self._graphs[key] = graph  # most recently used last
        return graph

    def __call__(self, reading: PointBatch,
                 draws: Optional[DrawSource] = None) -> ICPResult:
        """Register ``reading`` (already in map frame) against the stored map.

        Returns the correction transform, like lpm's ``icp(input)``."""
        ref, pack = self._ref_state
        if ref is None:
            raise RuntimeError("ICPEngine: set_map() before calling")
        if len(self.reading_filters):
            reading = self.reading_filters.apply(reading, draws)
        ref_normals = self.check_reference(ref)
        if self.inspector is not None:
            return self._solve_inspected(reading, ref, ref_normals, pack,
                                         draws)
        correction, overlap, iters, resid = self.solve(
            reading.positions, reading.mask, ref.positions, ref_normals,
            ref.mask, pack, draws)
        # this path reads its result at once (the pipelined Mapper does not)
        iters = int(iters)
        if self.last_replay is not None:
            self.last_replay.count(iters)
        correction = correction.cpu()
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

    def _solve_inspected(self, reading, ref, ref_normals, pack,
                         draws) -> ICPResult:
        """The inspected solve: one single-iteration solve per outer step
        (the reading moved by the transform so far), the inspector records
        (and, for VTKFileInspector, dumps) the moved reading after every
        iteration; the differential checker runs on the host.  The bound
        checker does not apply here, as in the JAX package."""
        cfg = dict(self.solve_config(), max_iter=1, diff_checker=None,
                   bound_checker=None, rematch_every=1)
        d = self.dim
        T = torch.eye(d + 1, dtype=torch.float32,
                      device=reading.positions.device)
        overlap = resid = torch.zeros(())
        min_t, min_r, smooth = self.diff_checker or (0.0, 0.0, 1)
        hist = []
        it = 0
        for it in range(1, self.max_iter + 1):
            moved = se3.apply_points(T, reading.positions)
            step, step_draws, index = self._step(draws)
            dT, overlap, _, resid, overflow = _icp_solve(
                moved, reading.mask, ref.positions, ref_normals, ref.mask,
                pack, step_filters=step, draws=step_draws,
                solve_index=index, **cfg)
            self.last_overflow = overflow
            if np.isfinite(self.match_max_dist):
                record_overflow("icp_matcher_sweep", overflow)
            T = dT.to(T.device) @ T
            dT_h = dT.cpu().numpy()
            cloud = None
            if self.inspector.dump_dir is not None:
                cloud = PointBatch(se3.apply_points(T, reading.positions),
                                   reading.mask, {})
            self.inspector.record(it, float(overlap), float(resid), cloud)
            if self.minimizer == "IdentityErrorMinimizer":
                break
            hist.append((float(np.linalg.norm(dT_h[:d, d])),
                         _rot_angle_np(dT_h[:d, :d])))
            if self.diff_checker is not None and len(hist) >= smooth:
                win = hist[-smooth:]
                if (sum(h[0] for h in win) / smooth < min_t
                        and sum(h[1] for h in win) / smooth < min_r):
                    break
        self.last_replay = None
        self.last_nn_grid = None
        return ICPResult(T.cpu(), overlap, it, resid)


# --------------------------------------------------------------------------
# the solve
# --------------------------------------------------------------------------

def _rot_angle_np(R: np.ndarray) -> float:
    if R.shape[0] == 2:
        return abs(float(np.arctan2(R[1, 0], R[0, 0])))
    return float(np.arccos(np.clip((np.trace(R) - 1.0) / 2.0, -1.0, 1.0)))


def _take(x: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """``x[i]`` for a 0-d index tensor, without reading ``i`` on the host
    (indexing with a 0-d tensor would)."""
    return x.index_select(0, i.reshape(1)).reshape(())


def _refuse_source_on_card(step, draws, device) -> None:
    """A caller-supplied ``source`` is asked on the host at every pass, which
    a solve on the card cannot do: say so instead of leaving the graph."""
    if (step is not None and device.type == "cuda" and draws is not None
            and draws.source is not None):
        raise ValueError(
            "readingStepDataPointsFilters on a CUDA device draw keyed on the "
            "card (DrawSource.keyed); a DrawSource with a caller-supplied "
            "`source` is asked on the host at every matcher pass and runs "
            "only on the CPU")


def _invert(order: torch.Tensor) -> torch.Tensor:
    """The inverse of a permutation, on its device without a host read."""
    return torch.empty_like(order).scatter_(
        0, order, torch.arange(order.shape[0], device=order.device))


class _Loop:
    """The ICP loop of one registration as state tensors and one iteration.

    The state is the JAX loop's ``(T, it, done, overlap, rms, hist)`` plus
    the overflow count of the matcher and, for the grid matcher, its
    counts of valid and fallback queries, as tensors on the reading's
    device.
    :meth:`start` sets it (and, with ``maxDist``, sorts the reading by x
    once); :meth:`iteration` is one JAX ``body``, written so that an
    iteration run after the stop changes no bit of the state: every update
    is ``where(active, new, old)`` with ``active = !done && it < max_iter``.
    Correspondences are searched at ``j == 0`` of a body of ``body_len``
    iterations (``rematch_every``, or 1 without reuse), so the JAX schedule
    ``it % rematch_every == 0`` is static.

    Step filters draw keyed by ``solve_index`` (0-d int64 on the device)
    and the state's ``it`` (``draws.KeyedDraws``), or, when ``draws`` has a
    caller-supplied ``source``, from that source once per pass (CPU only).

    Two loops run it: :meth:`run`, a Python loop that reads ``done``
    before each iteration (free on the CPU; on the card the yardstick the
    graph is held against), and :class:`_SolveGraph`, a CUDA graph that
    repeats :meth:`body` under a WHILE node.
    """

    def __init__(self, read_pos, read_mask, ref_pos, ref_norm, ref_mask,
                 ref_pack, *, dim, k, max_dist, outlier_filters, minimizer,
                 max_iter, diff_checker, bound_checker=None,
                 step_filters=None, draws=None, solve_index=None,
                 rematch_every=1):
        self.read_pos, self.read_mask = read_pos, read_mask
        self.ref_pos, self.ref_norm, self.ref_mask = ref_pos, ref_norm, ref_mask
        self.ref_pack = ref_pack
        self.dim = dim
        self.identity = minimizer == "IdentityErrorMinimizer"
        self.p2p = minimizer == "PointToPointErrorMinimizer"
        # IdentityErrorMinimizer never uses the matched pairs for
        # minimization -- only the overlap (fraction matched within
        # maxDist), for which 1-NN is equivalent to k-NN
        self.k = 1 if self.identity else k
        self.max_dist = max_dist
        self.bounded = bool(np.isfinite(max_dist))
        self.outlier_filters = outlier_filters
        self.max_iter = max_iter
        self.diff_checker = diff_checker
        self.bound_checker = bound_checker
        self.step_filters = step_filters
        self.dev = read_pos.device
        if step_filters is not None and draws is None:
            draws = DrawSource(0)
        _refuse_source_on_card(step_filters, draws, self.dev)
        self.draws = draws
        self.keyed = step_filters is not None and draws.source is None
        self.solve_index = (solve_index if solve_index is not None
                            else torch.zeros((), dtype=torch.int64,
                                             device=self.dev))
        self.reuse = rematch_every > 1 and not self.identity
        self.body_len = rematch_every if self.reuse else 1
        self.dof = 6 if dim == 3 else 3
        self.corr = None
        self.order = self.inv_order = None

    # ------------------------------------------------------------- state
    def start(self):
        """The initial state.  With ``maxDist`` the reading is sorted by x
        once and the whole solve runs in sweep order: rigid motion keeps the
        order near-sorted (window spans are re-measured from the moved
        coordinates every pass), and every consumer -- overlap, trimmed
        sort, normal equations -- is permutation invariant.  The step
        filters are the exception: they draw on the original rows."""
        f32, dev = torch.float32, self.dev
        pos, mask = self.read_pos, self.read_mask
        self.n_valid = torch.clamp(mask.to(f32).sum(), min=1.0)
        if self.bounded:
            q_x = torch.where(mask, pos[:, 0], torch.full_like(pos[:, 0], 1e9))
            order = torch.sort(q_x, stable=True).indices
            pos, mask = pos[order], mask[order]
            if self.step_filters is not None:
                # a row-local chain needs no inverse (_stepped_in_rows)
                self.order, self.inv_order = order, (
                    None if self.step_filters.row_local else _invert(order))
        self.read, self.mask = pos, mask
        hdim = self.dim + 1
        smooth_len = self.diff_checker[2] if self.diff_checker else 1
        self.eye = torch.eye(hdim, dtype=f32, device=dev)
        self.eye_dof = torch.eye(self.dof, dtype=f32, device=dev)
        self.T = self.eye.clone()
        self.it = torch.zeros((), dtype=torch.int32, device=dev)
        self.done = torch.zeros((), dtype=torch.bool, device=dev)
        self.overlap = torch.zeros((), dtype=f32, device=dev)
        self.rms = torch.zeros((), dtype=f32, device=dev)
        self.hist = torch.full((smooth_len, 2), float("inf"), dtype=f32,
                               device=dev)
        self.overflow = torch.zeros((), dtype=torch.int64, device=dev)
        # the grid matcher's (valid queries, fallback queries), None for
        # another pack
        self.nn_grid = (torch.zeros(2, dtype=torch.int64, device=dev)
                        if isinstance(self.ref_pack, GridPack) else None)

    def outputs(self):
        """``(T, overlap, iterations, rms, overflow)`` on the reading's
        device."""
        return (self.T, self.overlap, self.it, self.rms, self.overflow)

    # --------------------------------------------------------- iteration
    def iteration(self, j: int, body: Optional[graph_loop.WhileBody] = None):
        """One iteration of the loop, masked by ``active``; ``j`` is its
        place in the body (0 searches correspondences).  The commit is one
        ``loop_commit`` (a kernel on the card); ``body``, the WHILE node's
        body that this iteration ends, gets its condition from it."""
        p = se3.apply_points(self.T, self.read)  # [N, D]
        fresh = j == 0 or not self.reuse
        if fresh:
            self.corr = self._match_and_weigh(p)
        p_matched, q, qn, w, overlap, overflow = self.corr
        if not self.reuse:
            # the step filters may move points (voxel centroids): without
            # reuse the minimizer sees the positions the pairs were matched
            # from, as the JAX body does
            p = p_matched
        rms = None
        if self.identity:
            dT = self.eye
        elif self.p2p:
            dT, rms = p2p_step(p, q, w)
        else:
            dT, rms = self._minimize_plane(p, q, qn, w)
        graph_loop.loop_commit(
            dT, self.T, self.it, self.done, self.hist, overlap, self.overlap,
            max_iter=self.max_iter, rms_new=rms,
            rms=None if rms is None else self.rms,
            overflow_new=overflow if fresh else None,
            overflow=self.overflow if fresh else None,
            identity=self.identity, diff_checker=self.diff_checker,
            bound_checker=self.bound_checker, body=body)

    def body(self, while_body: Optional[graph_loop.WhileBody] = None):
        """One run of the WHILE node's body: ``body_len`` iterations, the
        first of which searches correspondences; the last sets the
        condition of ``while_body``."""
        for j in range(self.body_len):
            self.iteration(j, while_body if j == self.body_len - 1 else None)

    def run(self):
        """The loop under Python: ``done`` is read before every iteration.
        Returns :meth:`outputs`."""
        self.start()
        it = 0
        while it < self.max_iter and not bool(self.done):
            self.iteration(it % self.body_len)
            it += 1
        return self.outputs()

    # ------------------------------------------------------------- pieces
    def _stepped(self, p, cur_mask):
        """lpm readingStepDataPointsFilters: a fresh copy of the moved
        reading filtered at every pass, draw ``i`` landing on reading
        point ``i`` whether or not the sweep sorted the reading.  Returns
        the stepped positions and mask in the solve's row order."""
        if self.step_filters.row_local:
            return self._stepped_in_rows(p, cur_mask)
        return self._stepped_permuted(p, cur_mask)

    def _step_draws(self):
        return (self.draws.keyed(self.solve_index, self.it) if self.keyed
                else self.draws)

    def _stepped_in_rows(self, p, cur_mask):
        """A row-local chain in the solve's row order, handed the sort as
        ``rows``: the positions stay, only the mask is new."""
        stepped = self.step_filters._apply_impl(
            PointBatch(p, cur_mask, {}), self._step_draws(), rows=self.order)
        return p, stepped.mask

    def _stepped_permuted(self, p, cur_mask):
        """Any chain on the reading in its original row order (permuted
        back when the sweep sorted it), its outputs permuted forward."""
        draws = self._step_draws()
        if self.order is None:
            stepped = self.step_filters._apply_impl(
                PointBatch(p, cur_mask, {}), draws)
            return stepped.positions, stepped.mask
        inv = self.inv_order
        if inv is None:  # a row-local chain's solve builds no inverse
            inv = self.inv_order = _invert(self.order)
        stepped = self.step_filters._apply_impl(
            PointBatch(p[inv], cur_mask[inv], {}), draws)
        return stepped.positions[self.order], stepped.mask[self.order]

    def _match_and_weigh(self, p):
        """Correspondences of the moved reading and their outlier weights:
        ``(p [N,D], q [N,k,D], qn [N,k,D], w [N,k], overlap, overflow)`` on
        the reading's device, ``p`` the positions matched from (the
        stepped ones, in the solve's row order)."""
        f32 = torch.float32
        cur_mask = self.mask
        if self.step_filters is not None:
            p, cur_mask = self._stepped(p, cur_mask)
        if self.bounded:
            # q_tile=1024: tight per-tile x-spans keep the true candidate
            # range inside W at map scale
            d2, idx, overflow = sweep_knn(p, self.ref_pos, cur_mask,
                                          self.ref_mask, k=self.k,
                                          max_radius=float(self.max_dist),
                                          q_tile=1024, W=8192,
                                          presorted=self.ref_pack,
                                          assume_sorted=True)
        elif isinstance(self.ref_pack, GridPack):
            d2, idx = knn_grid(p, cur_mask, self.ref_pack, stats=self.nn_grid)
            overflow = torch.zeros((), dtype=torch.int64, device=self.dev)
        else:
            d2, idx = knn(p, self.ref_pos, cur_mask, self.ref_mask, k=self.k,
                          pack=self.ref_pack)
            overflow = torch.zeros((), dtype=torch.int64, device=self.dev)
        w = (idx >= 0).to(f32)  # [N, k]
        safe = torch.clamp(idx, min=0)
        qn = self.ref_norm[safe]  # [N, k, D]
        for kind, param in self.outlier_filters:
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
                w = w * (d2 <= _take(srt, cut_idx))
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
                med = 0.5 * _take(srt, lo) + 0.5 * _take(srt, hi)
                w = w * (d2 <= float(np.float32(param * param)) * med)
            elif kind == "normal":
                # angle between reading ray and ref normal below maxAngle
                pdir = p / torch.clamp(
                    torch.linalg.norm(p, dim=1, keepdim=True), min=1e-9)
                cosang = torch.abs(torch.einsum("nd,nkd->nk", pdir, qn))
                w = w * (torch.acos(torch.clamp(cosang, 0, 1))
                         <= float(np.float32(param)))
        q = self.ref_pos[safe]  # [N, k, D]
        matched = torch.any(idx >= 0, dim=1) & cur_mask
        overlap = matched.to(f32).sum() / self.n_valid
        return p, q, qn, w, overlap, overflow

    def _minimize_plane(self, p, q, qn, w):
        """Weighted point-to-plane Gauss-Newton step on the reading's
        device: normal equations, damped solve, exp map.  Returns the
        increment ``dT`` and the rms residual of the weighted pairs."""
        dof = self.dof
        r = torch.einsum("nkd,nkd->nk", qn, p[:, None, :] - q)  # [N, k]
        if self.dim == 3:
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
        JtJ = JtJ + lam * self.eye_dof
        # solve_ex: the damped matrix is never singular, and the error
        # check of linalg.solve would read on the host
        dx = -torch.linalg.solve_ex(JtJ, Jtr).result
        dT = se3.exp_se3(dx) if self.dim == 3 else se3.exp_se2(dx)
        return dT, torch.sqrt(wrr / wsum)


def _icp_solve(read_pos, read_mask, ref_pos, ref_norm, ref_mask,
               ref_pack, *, dim, k, max_dist, outlier_filters,
               minimizer, max_iter, diff_checker, bound_checker=None,
               step_filters=None, draws=None, solve_index: int = 0,
               rematch_every=1):
    """One ICP registration under the Python loop (:meth:`_Loop.run`):
    loop{ match -> weight -> minimize }.

    ``ref_pack`` is the matcher's pack for ``ref_pos`` / ``ref_mask``
    (``ICPEngine.build_ref_pack``, which picks its kind; built once per
    change of the reference and cached across scans, so it stays out of the
    iteration loop).  ``step_filters`` (a ``FilterChain``) edits the
    reading's mask at every matcher pass, drawing keyed by ``draws``' seed
    and ``solve_index`` (or from its caller-supplied ``source``).

    Returns ``(correction (D+1,D+1), overlap, iterations (int32), rms
    residual, overflow)``, all on the reading's device; ``overflow`` sums
    the sweep matcher's overflowing tiles over all passes (0 for a matcher
    without ``maxDist``).
    """
    return _loop(read_pos, read_mask, ref_pos, ref_norm, ref_mask, ref_pack,
                 dim=dim, k=k, max_dist=max_dist,
                 outlier_filters=outlier_filters, minimizer=minimizer,
                 max_iter=max_iter, diff_checker=diff_checker,
                 bound_checker=bound_checker, step_filters=step_filters,
                 draws=draws, solve_index=solve_index,
                 rematch_every=rematch_every).run()


def _loop(*args, solve_index: int = 0, **kw) -> _Loop:
    """The :class:`_Loop` of :func:`_icp_solve`'s arguments, its solve
    index as a 0-d int64 on the reading's device."""
    return _Loop(*args, solve_index=torch.full(
        (), int(solve_index), dtype=torch.int64, device=args[0].device),
        **kw)


# --------------------------------------------------------------------------
# the solve as one CUDA graph
# --------------------------------------------------------------------------

# the kernel wrappers a solve launches
_COUNTED = (sweep_knn, knn, knn_grid, kabsch, p2p_step, philox_uniform,
            philox_keep, graph_loop.loop_commit)


def _counters():
    return [(f.launches, dict(f.launches_by_shape)) for f in _COUNTED]


def _restore_counters(state) -> None:
    for f, (n, by) in zip(_COUNTED, state):
        f.launches, f.launches_by_shape = n, by


class GraphReplay(NamedTuple):
    """What one replay of a solve graph launched for each run of its body:
    the wrappers count their launches when the body is captured, not when
    it replays, so the launches are added here once the iterations are
    known (``count``)."""
    per_body: tuple  # per wrapper of _COUNTED: (launches, {shape: launches})
    body_len: int

    def count(self, iterations: int) -> None:
        bodies = -(-int(iterations) // self.body_len)
        for f, (n, by) in zip(_COUNTED, self.per_body):
            f.launches += n * bodies
            for key, v in by.items():
                f.launches_by_shape[key] = \
                    f.launches_by_shape.get(key, 0) + v * bodies


class _SolveGraph:
    """The solve of one configuration at one pair of capacities, captured
    once as a CUDA graph: the initial state and the sort of the reading,
    then a WHILE node (``ops/graph_loop.py``) whose body is
    :meth:`_Loop.body`.  A replay runs the whole loop with no read on the
    host; the body may run up to ``rematch_every - 1`` masked iterations
    past the stop, which change nothing.

    The graph reads static buffers: the reading, the reference positions,
    normals and mask and the matcher's pack are copied in before a replay
    (the reference only when another one is passed, i.e. after a merge).
    The outputs are copied out after each replay, so that nothing a caller
    keeps aliases the graph's state while later scans are in flight.  The
    body's temporaries come from a memory pool of the graph's own."""

    def __init__(self, cfg, read_pos, read_mask, ref_pos, ref_norm, ref_mask,
                 ref_pack, step_filters=None, draws=None):
        self._inputs = [torch.empty_like(t) for t in (read_pos, read_mask)]
        # the keyed draws' solve index, copied in before each replay
        self._solve = torch.zeros((), dtype=torch.int64,
                                  device=read_pos.device)
        self._ref = [torch.empty_like(t) for t in (ref_pos, ref_norm,
                                                   ref_mask)]
        self._pack = type(ref_pack)(*[
            torch.empty_like(f) if isinstance(f, torch.Tensor) else f
            for f in ref_pack])
        self._src = None  # the reference tensors last copied in
        self.loop = _Loop(*self._inputs, *self._ref, self._pack,
                          step_filters=step_filters, draws=draws,
                          solve_index=self._solve, **cfg)
        self._copy_in(read_pos, read_mask, ref_pos, ref_norm, ref_mask,
                      ref_pack)
        self._body_stream = torch.cuda.Stream()
        self._pool = torch.cuda.MemPool()
        before = _counters()
        # warm-up on the body stream: library handles and workspaces (cuBLAS,
        # cuSOLVER) and the kernels' libraries exist before the capture,
        # which may not create them
        cur = torch.cuda.current_stream()
        self._body_stream.wait_stream(cur)
        with torch.cuda.stream(self._body_stream):
            self.loop.start()
            self.loop.body()
        cur.wait_stream(self._body_stream)
        warm = _counters()
        self.graph = torch.cuda.CUDAGraph()
        capture = torch.cuda.Stream()
        with torch.cuda.stream(capture), graph_loop.no_gc():
            # thread_local: a map-update thread may use the card meanwhile
            self.graph.capture_begin(capture_error_mode="thread_local")
            try:
                self.loop.start()
                with graph_loop.while_node(self.loop.it, self.loop.done,
                                           self.loop.max_iter,
                                           self._body_stream,
                                           self._pool) as while_body:
                    self.loop.body(while_body)
            finally:
                self.graph.capture_end()
        captured = _counters()
        _restore_counters(before)  # warm-up and capture launched nothing
        self.replay = GraphReplay(tuple(
            (n1 - n0, {key: v - b0.get(key, 0) for key, v in b1.items()})
            for (n0, b0), (n1, b1) in zip(warm, captured)),
            self.loop.body_len)

    def _copy_in(self, read_pos, read_mask, ref_pos, ref_norm, ref_mask,
                 ref_pack):
        self._inputs[0].copy_(read_pos)
        self._inputs[1].copy_(read_mask)
        src = (ref_pos, ref_norm, ref_mask, ref_pack)
        if self._src is not None and all(
                a is b for a, b in zip(src, self._src)):
            return
        for dst, t in zip(self._ref, src[:3]):
            dst.copy_(t)
        for dst, t in zip(self._pack, ref_pack):
            if isinstance(t, torch.Tensor):
                dst.copy_(t)
        self._src = src  # held, so that `is` never meets a recycled id

    def run(self, read_pos, read_mask, ref_pos, ref_norm, ref_mask,
            ref_pack, solve_index: int = 0):
        """Copy in (the solve index of the keyed draws through pinned memory,
        without a wait), replay, copy out: ``(T, overlap, iterations, rms,
        overflow)`` as fresh tensors, and the grid matcher's counts as
        ``last_nn_grid`` (None for another pack)."""
        self._copy_in(read_pos, read_mask, ref_pos, ref_norm, ref_mask,
                      ref_pack)
        self._solve.copy_(torch.tensor(int(solve_index), dtype=torch.int64
                                       ).pin_memory(), non_blocking=True)
        graph_loop.replay(self.graph)
        loop = self.loop
        self.last_nn_grid = (None if loop.nn_grid is None
                             else loop.nn_grid.clone())
        return tuple(t.clone() for t in loop.outputs())

    def close(self) -> None:
        """Free the graph before the pools its body reads from."""
        self.graph.reset()
        self._pool = None
