"""The cell-grid 1-NN of the unbounded ICP matcher (``ops/nn_grid.py``) on
the CPU: its plain version, and the grid pack it reads, against
``knn_plain`` bit for bit in d2 and index; which pack the engine builds;
the engine's solve through the grid against its solve by brute force.

The kernel (``csrc/knn_grid.cu``) runs only on the card, where
``chip_smoke.py`` holds it against ``knn_brute``.
"""
import numpy as np
import pytest
import torch

from norlab_icp_mapper_tpu_torch.icp import engine as te
from norlab_icp_mapper_tpu_torch.ops import nn as tnn
from norlab_icp_mapper_tpu_torch.ops import nn_grid as G
from norlab_icp_mapper_tpu_torch.points import PointBatch


@pytest.fixture
def rng():
    return np.random.default_rng(1234)


def _f32(a):
    return torch.from_numpy(np.asarray(a, dtype=np.float32))


def _hold(query, qmask, ref, rmask, shell_cap=G.SHELL_CAP):
    """knn_grid_plain on the grid pack against knn_plain: d2 and index
    equal bit for bit on every row.  Returns the fallback count."""
    pack = G.build_grid_pack(ref, rmask)
    d, i, fallbacks = G.knn_grid_plain(query, qmask, pack, shell_cap)
    d_p, i_p = tnn.knn_plain(query, ref, qmask, rmask, k=1)
    assert torch.equal(d.view(torch.int32), d_p.view(torch.int32))
    assert torch.equal(i, i_p)
    if shell_cap == G.SHELL_CAP:
        # the wrapper on a CPU tensor is the plain version
        d_w, i_w = G.knn_grid(query, qmask, pack)
        assert torch.equal(d_w, d) and torch.equal(i_w, i)
    return fallbacks


def _cells(pack, pts):
    """The grid cell (x, y, z) of each point, as build_grid_pack assigns."""
    lo, inv_h = pack.grid_f[:3], pack.grid_f[4]
    dims = pack.grid_i[:3].to(torch.float32)
    cf = torch.floor((pts - lo) * inv_h)
    return torch.minimum(torch.clamp(cf, min=0.0), dims - 1.0).long()


def _walls(rng, n, offset=0.0):
    """A hall-like cloud: points near the faces of a 12 x 6 x 3 m box, 1 cm
    of noise."""
    pts = rng.uniform([0, 0, 0], [12, 6, 3], size=(n, 3))
    face = rng.integers(0, 6, n)
    for a in range(3):
        hi = (12, 6, 3)[a]
        pts[face == 2 * a, a] = 0.0
        pts[face == 2 * a + 1, a] = hi
    pts += rng.normal(scale=0.01, size=pts.shape)
    return pts + offset


@pytest.mark.parametrize("dim", [2, 3])
@pytest.mark.parametrize("kind", ["uniform", "walls"])
def test_random_clouds(rng, dim, kind):
    m, n = 4000, 1500
    if kind == "uniform":
        ref = rng.uniform(-5, 5, size=(m, 3))
    else:
        ref = _walls(rng, m)
    query = ref[rng.integers(0, m, n)] + rng.normal(scale=0.2, size=(n, 3))
    rmask = rng.random(m) > 0.25
    qmask = rng.random(n) > 0.1
    _hold(_f32(query[:, :dim]), torch.from_numpy(qmask),
          _f32(ref[:, :dim]), torch.from_numpy(rmask))


def test_duplicate_references_take_the_lowest_index(rng):
    base = rng.uniform(0, 4, size=(600, 3))
    ref = np.concatenate([base, base, base[::-1]])  # each point 3 times
    query = base[rng.integers(0, 600, 400)] + rng.normal(scale=0.05,
                                                         size=(400, 3))
    # the references themselves too: d2 = 0 three times
    query = np.concatenate([query, base[:200]])
    rmask = np.ones(len(ref), bool)
    rmask[::7] = False  # so that some first copies are masked
    _hold(_f32(query), None, _f32(ref), torch.from_numpy(rmask))
    pack = G.build_grid_pack(_f32(ref), torch.from_numpy(rmask))
    _, i, _ = G.knn_grid_plain(_f32(base[:200]), None, pack)
    first = np.where(rmask[:600], np.arange(600), np.arange(600) + 600)
    assert np.array_equal(i[:, 0].numpy(), first[:200])


def test_ties_across_cell_faces(rng):
    """References on a lattice of 1/4 m and queries at the midpoints of
    neighbours: exact ties, many of them between two cells."""
    g = np.arange(0, 3.01, 0.25)
    lat = np.stack(np.meshgrid(g, g, g, indexing="ij"), -1).reshape(-1, 3)
    ref = lat[rng.permutation(len(lat))]
    pick = rng.integers(0, len(ref), 500)
    axis = rng.integers(0, 3, 500)
    step = np.zeros((500, 3))
    step[np.arange(500), axis] = 0.125
    query = ref[pick] + step
    ref_t, q_t = _f32(ref), _f32(query)
    _hold(q_t, None, ref_t, None)
    # the two lattice neighbours of a midpoint lie in different cells for
    # some queries, and tie exactly
    pack = G.build_grid_pack(ref_t, None)
    c_lo = _cells(pack, q_t - _f32(step))
    c_hi = _cells(pack, q_t + _f32(step))
    d_lo = ((q_t - _f32(step)) - q_t).pow(2).sum(1)
    d_hi = ((q_t + _f32(step)) - q_t).pow(2).sum(1)
    across = (c_lo != c_hi).any(1) & (d_lo == d_hi)
    assert int(across.sum()) > 20


def test_points_exactly_on_cell_faces(rng):
    """References and queries placed on the faces the grid's own edge
    draws (the bounding box and the capacity fix the edge, so points added
    inside it keep the faces where they were)."""
    m = 3000
    ref = rng.uniform(0, 8, size=(m, 3))
    ref[0], ref[1] = 0.0, 8.0  # the bounding box
    mask = np.zeros(m, bool)
    mask[:1500] = True
    pack0 = G.build_grid_pack(_f32(ref), torch.from_numpy(mask))
    lo, h = pack0.grid_f[:3].numpy(), pack0.grid_f[3].numpy()
    k = rng.integers(1, 10, size=(1500, 3)).astype(np.float32)
    on = lo + k * h  # f32 products, as the kernel draws the faces
    keep = (on < 8).all(1)
    face = rng.uniform(0, 8, size=(1500, 3)).astype(np.float32)
    which = rng.integers(0, 3, 1500)
    face[np.arange(1500), which] = on[np.arange(1500), which]
    ref[1500:] = np.where(keep[:, None], face, ref[1500:])
    mask[1500:] = True
    pack = G.build_grid_pack(_f32(ref), torch.from_numpy(mask))
    assert torch.equal(pack.grid_f, pack0.grid_f)  # same faces
    query = np.concatenate([face[:400], face[400:800] + rng.normal(
        scale=0.05, size=(400, 3))])
    _hold(_f32(query), None, _f32(ref), torch.from_numpy(mask))


@pytest.mark.parametrize("offset", [-60.0, 60.0])
def test_coordinates_offset(rng, offset):
    ref = _walls(rng, 4000, offset)
    query = ref[rng.integers(0, 4000, 1200)] + rng.normal(scale=0.3,
                                                          size=(1200, 3))
    _hold(_f32(query), None, _f32(ref), None)


def test_queries_outside_the_bounding_box(rng):
    ref = rng.uniform(0, 5, size=(3000, 3))
    query = np.concatenate([
        rng.uniform(-1.0, 0.0, size=(200, 3)),  # just below every axis
        rng.uniform(5.0, 6.5, size=(200, 3)),   # just above
        rng.uniform(-3, 8, size=(400, 3)),      # around
        np.array([[1e4, 0, 0], [0, -1e4, 2], [3e30, 0, 0]]),
    ])
    assert _hold(_f32(query), None, _f32(ref), None) > 0  # the far ones


def test_a_query_beyond_the_shell_cap_takes_the_exact_fallback(rng):
    ref = _walls(rng, 3000)
    query = np.concatenate([
        ref[rng.integers(0, 3000, 300)] + rng.normal(scale=0.05,
                                                     size=(300, 3)),
        np.array([[40.0, 3.0, 1.5], [6.0, -30.0, 1.5], [6.0, 3.0, 1.5]]),
    ])
    q, r = _f32(query), _f32(ref)
    assert _hold(q, None, r, None) >= 2  # the two far queries at least
    # no shell at all beyond the query's own cell: most queries fall back
    assert _hold(q, None, r, None, shell_cap=0) > 150
    # coordinates that are not finite go to the fallback too
    q[5, 0] = float("nan")
    q[6, 2] = float("inf")
    assert _hold(q, None, r, None) >= 4


@pytest.mark.parametrize("case", ["empty_map", "one_reference",
                                  "no_valid_query", "capacity_zero"])
def test_degenerate_inputs(rng, case):
    ref = _f32(rng.uniform(0, 3, size=(500, 3)))
    query = _f32(rng.uniform(-1, 4, size=(300, 3)))
    rmask = torch.ones(500, dtype=torch.bool)
    qmask = torch.ones(300, dtype=torch.bool)
    if case == "empty_map":
        rmask[:] = False
    elif case == "one_reference":
        rmask[:] = False
        rmask[137] = True
    elif case == "no_valid_query":
        qmask[:] = False
    else:
        ref, rmask = ref[:0], rmask[:0]
    assert _hold(query, qmask, ref, rmask) == 0
    d, i, _ = G.knn_grid_plain(query, qmask,
                               G.build_grid_pack(ref, rmask))
    if case == "one_reference":
        assert bool((i == 137).all())
    else:
        assert bool(torch.isinf(d).all()) and bool((i == -1).all())


@pytest.mark.parametrize("axis", [0, 2])
def test_flat_cloud(rng, axis):
    """Zero extent on one axis (a floor, a 2-D scan lifted to 3-D): one
    cell across it."""
    ref = rng.uniform(0, 6, size=(3000, 3))
    ref[:, axis] = 1.5
    query = ref[rng.integers(0, 3000, 800)] + rng.normal(scale=0.2,
                                                         size=(800, 3))
    pack = G.build_grid_pack(_f32(ref), None)
    assert int(pack.grid_i[axis]) == 1
    _hold(_f32(query), None, _f32(ref), None)


def test_the_pack_sorts_every_finite_valid_reference_into_its_cell(rng):
    m = 5000
    ref = _f32(_walls(rng, m))
    ref[10, 1] = float("nan")
    ref[11, 0] = float("inf")
    rmask = torch.from_numpy(rng.random(m) > 0.3)
    rmask[10] = rmask[11] = True
    pack = G.build_grid_pack(ref, rmask)
    cells = G.grid_cells(m)
    assert pack.cell_start.shape == (cells + 1,)
    assert int(pack.grid_i[3]) == cells
    nx, ny, nz = (int(v) for v in pack.grid_i[:3])
    assert nx * ny * nz <= cells
    n_live = int(rmask.sum()) - 2  # the two not finite are left out
    assert int(pack.cell_start[-1]) == n_live
    assert bool((pack.cell_start[1:] >= pack.cell_start[:-1]).all())
    pts = pack.cell_ref4[:n_live, :3]
    c = _cells(pack, pts)
    key = (c[:, 2] * ny + c[:, 1]) * nx + c[:, 0]
    pos = torch.arange(n_live)
    cs = pack.cell_start.long()
    assert bool(((cs[key] <= pos) & (pos < cs[key + 1])).all())
    ids = pack.cell_ref4.view(torch.int32)[:n_live, 3].long()
    assert torch.equal(torch.sort(ids).values,
                       torch.nonzero(rmask & torch.isfinite(ref).all(1)
                                     ).reshape(-1))
    # the shapes follow the capacity alone
    other = G.build_grid_pack(ref * 3.0, ~rmask)
    for a, b in zip(pack, other):
        if isinstance(a, torch.Tensor):
            assert a.shape == b.shape and a.dtype == b.dtype


@pytest.mark.parametrize("max_dist,k,device,kind", [
    (float("inf"), 1, "cuda", "grid"),
    (float("inf"), 1, "cpu", "brute"),
    (float("inf"), 3, "cuda", "brute"),
    (float("inf"), 10, "cpu", "brute"),
    (2.0, 1, "cuda", "sweep"),
    (0.5, 3, "cpu", "sweep"),
])
def test_the_matcher_picks_the_grid_only_unbounded_at_k1_on_the_card(
        max_dist, k, device, kind):
    assert G.matcher_pack_kind(max_dist, k, torch.device(device)) == kind


def _engine(k=1):
    return te.ICPEngine({
        "matcher": {"KDTreeMatcher": {"knn": k}},
        "outlierFilters": [{"TrimmedDistOutlierFilter": {"ratio": 0.85}}],
        "errorMinimizer": "PointToPointErrorMinimizer",
        "transformationCheckers": [
            {"CounterTransformationChecker": {"maxIterationCount": 9}}],
    })


def test_the_engine_solve_through_the_grid_equals_the_brute_force_solve(
        rng, monkeypatch):
    """On the CPU the engine builds the brute-force pack; told that its
    device takes the grid, it builds the grid pack and its solve (the plain
    version at every matcher pass) gives the same correction bit for bit,
    and counts the passes' queries."""
    world = _f32(_walls(rng, 3000))
    wmask = torch.from_numpy(rng.random(3000) > 0.1)
    a = 0.03
    R = torch.tensor([[np.cos(a), -np.sin(a), 0], [np.sin(a), np.cos(a), 0],
                      [0, 0, 1]], dtype=torch.float32)
    read = world[rng.integers(0, 3000, 700)] @ R.T + torch.tensor(
        [0.05, -0.04, 0.02])
    rmask = torch.from_numpy(rng.random(700) > 0.05)
    ref = PointBatch(world, wmask, {})
    eng = _engine()
    plain_pack = eng.build_ref_pack(ref)
    assert type(plain_pack) is tnn.KnnPack
    monkeypatch.setattr(te, "matcher_pack_kind",
                        lambda max_dist, k, device: "grid")
    grid_pack = eng.build_ref_pack(ref)
    assert type(grid_pack) is G.GridPack
    normals = torch.zeros_like(world)
    want = eng.solve(read, rmask, world, normals, wmask, plain_pack)
    assert eng.last_nn_grid is None
    got = eng.solve(read, rmask, world, normals, wmask, grid_pack)
    assert torch.equal(got.correction, want.correction)
    assert int(got.iterations) == int(want.iterations) == 9
    passes = -(-9 // te._rematch_every())
    assert eng.last_nn_grid.tolist()[0] == passes * int(rmask.sum())


def test_the_mapper_counts_the_grid_queries_from_the_solve_mirror(
        monkeypatch):
    """``Mapper(None)`` over a few scans with the grid pack forced on the
    CPU: the poses of the drive without it, bit for bit, and the grid's
    counters in the timer, harvested with the iterations."""
    import norlab_icp_mapper_tpu_torch as nt
    from test_torch_mapper_e2e import make_world, pose_at, scan_at

    world = make_world(np.random.default_rng(42), n=300)

    def drive():
        m = nt.Mapper(None, device="cpu")
        m.timer.enabled = True
        for i, x in enumerate((2.0, 2.6, 3.2)):
            scan = nt.PointBatch.from_numpy(scan_at(world, pose_at(x)),
                                            device="cpu")
            m.process_input(m.apply_input_filters(scan), pose_at(x),
                            i * int(1e8))
        m.drain()
        return m, m.timer.totals()

    plain, plain_counts = drive()
    assert "count.nn_grid_queries" not in plain_counts
    monkeypatch.setattr(te, "matcher_pack_kind",
                        lambda max_dist, k, device: "grid")
    grid, counts = drive()
    assert type(grid.icp._ref_pack) is G.GridPack
    for a, b in zip(grid.get_trajectory().poses,
                    plain.get_trajectory().poses):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert counts["count.nn_grid_queries"] > 0
    assert 0 <= counts["count.nn_grid_fallbacks"] \
        <= counts["count.nn_grid_queries"]
    assert counts["count.icp_iterations"] == plain_counts[
        "count.icp_iterations"]
