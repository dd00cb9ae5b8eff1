"""The port as a package: what it imports, its own copies of the numpy-only
modules, and how its entry points treat devices."""
import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import norlab_icp_mapper_tpu as nj
from norlab_icp_mapper_tpu import cell_manager as jcm, registry as jreg
from norlab_icp_mapper_tpu.io import vtk as jvtk
import norlab_icp_mapper_tpu_torch as nt
from norlab_icp_mapper_tpu_torch import (cell_manager as tcm, convert,
                                         registry as treg)
from norlab_icp_mapper_tpu_torch.io import vtk as tvtk
from norlab_icp_mapper_tpu_torch.ops import _build, eigen, nn_sweep, pca

ROOT = pathlib.Path(__file__).resolve().parent.parent
PKG = ROOT / "norlab_icp_mapper_tpu_torch"


def test_import_pulls_in_neither_jax_nor_the_jax_package():
    code = ("import sys; import norlab_icp_mapper_tpu_torch as m; "
            "import norlab_icp_mapper_tpu_torch.convert; "
            "import norlab_icp_mapper_tpu_torch.build_map; "
            "import norlab_icp_mapper_tpu_torch.io.loader; "
            "import norlab_icp_mapper_tpu_torch.io.native; "
            "import norlab_icp_mapper_tpu_torch.parallel.distributed; "
            "import norlab_icp_mapper_tpu_torch.parallel.multihost; "
            "import norlab_icp_mapper_tpu_torch.parallel.sharded_map; "
            "bad = [k for k in sys.modules if k == 'jax' or "
            "k.startswith('jax.') or k == 'jaxlib' or "
            "k == 'norlab_icp_mapper_tpu' or "
            "k.startswith('norlab_icp_mapper_tpu.')]; "
            "print(bad); sys.exit(1 if bad else 0)")
    # -S keeps site hooks (which may pre-import jax) out; the repo root and
    # the interpreter's site-packages go on the path by hand
    import site
    paths = [str(ROOT)] + site.getsitepackages()
    out = subprocess.run([sys.executable, "-S", "-c",
                          f"import sys; sys.path[:0] = {paths!r}; " + code],
                         capture_output=True, text=True, cwd=str(ROOT))
    assert out.returncode == 0, out.stdout + out.stderr


def _program_files():
    files = sorted(PKG.rglob("*.py")) + sorted(PKG.rglob("*.cu")) \
        + sorted(PKG.rglob("*.cuh")) + sorted(PKG.rglob("*.cpp")) \
        + [ROOT / "chip_smoke.py"]
    return [f for f in files if "build" not in f.parts]


@pytest.mark.parametrize("path", _program_files(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_file_names_jax_or_the_jax_package(path):
    text = path.read_text()
    assert not re.search(r"^\s*(import|from)\s+jax", text, re.M)
    assert "import jax" not in text
    assert not re.search(r"norlab_icp_mapper_tpu(?!_torch)", text)


def test_full_f32_matmul_is_pinned():
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.get_float32_matmul_precision() == "highest"


def test_kernel_sources_ship_with_the_package():
    for name in _build.KERNEL_SOURCES:
        assert (PKG / "csrc" / f"{name}.cu").is_file()
    assert (PKG / "csrc" / "sweep_common.cuh").is_file()
    assert (PKG / "csrc" / "sym_eig.cuh").is_file()
    assert (PKG / "csrc" / "vtk_fast.cpp").is_file()  # host code, g++
    manifest = (ROOT / "MANIFEST.in").read_text()
    assert "recursive-include norlab_icp_mapper_tpu_torch/csrc" in manifest
    assert "*.cpp" in manifest
    ignore = (ROOT / ".gitignore").read_text().splitlines()
    assert "norlab_icp_mapper_tpu_torch/build/" in ignore
    assert _build.build_dir() == PKG / "build"
    # setuptools finds the package by the existing include pattern
    import tomllib
    cfg = tomllib.loads((ROOT / "pyproject.toml").read_text())
    patterns = cfg["tool"]["setuptools"]["packages"]["find"]["include"]
    import fnmatch
    assert any(fnmatch.fnmatch("norlab_icp_mapper_tpu_torch.ops", p)
               for p in patterns)


# ------------------------------------------------ copies of numpy-only modules

def test_registry_copy_behaves_as_the_original():
    for reg in (jreg, treg):
        class Plug(reg.ParametrizedPlugin):
            NAME = "Plug"
            PARAMS = {"a": reg.Param("a", 1.0, float, 0, 2),
                      "b": reg.Param("b", None, str)}
        r = reg.Registry("Thing")
        r.register(Plug)
        assert r.names() == ["Plug"]
        assert r.create_from_yaml_entry({"Plug": {"b": "x"}}).params == \
            {"a": 1.0, "b": "x"}
        with pytest.raises(ValueError, match="missing required parameter 'b'"):
            r.create("Plug", {})
        with pytest.raises(ValueError, match="above maximum"):
            r.create("Plug", {"a": 3, "b": "x"})
        with pytest.raises(ValueError, match="unknown parameter"):
            r.create("Plug", {"b": "x", "c": 1})
        with pytest.raises(KeyError, match="unknown Thing 'Nope'"):
            r.create("Nope")
        assert Plug.available_parameters()["a"]["max"] == 2


def _cloud(rng, n=40):
    return (rng.normal(size=(n, 3)).astype(np.float32),
            {"normals": rng.normal(size=(n, 3)).astype(np.float32),
             "probabilityDynamic": rng.random((n, 1)).astype(np.float32),
             "stamp": rng.integers(0, 10**9, (n, 1)).astype(np.float64)})


def test_vtk_copy_round_trips_like_the_original(rng, tmp_path):
    pos, desc = _cloud(rng)
    pj, pt = tmp_path / "j.vtk", tmp_path / "t.vtk"
    jvtk.write_vtk(str(pj), pos, desc)
    tvtk.write_vtk(str(pt), pos, desc)
    # the two writers differ in the comment line only
    strip = lambda p: [ln for i, ln in enumerate(p.read_text().splitlines())
                       if i != 1]
    assert strip(pj) == strip(pt)
    for reader in (jvtk.read_vtk, tvtk.read_vtk):
        for path in (pj, pt):
            p2, d2 = reader(str(path))
            np.testing.assert_allclose(p2, pos, rtol=1e-6)
            assert sorted(d2) == sorted(desc)
            np.testing.assert_array_equal(d2["stamp"], desc["stamp"])
            assert d2["stamp"].dtype == np.float64
            np.testing.assert_allclose(d2["normals"], desc["normals"],
                                       rtol=1e-6)
    # 2-D clouds save with z = 0
    tvtk.write_vtk(str(pt), pos[:, :2])
    p3, _ = tvtk.read_vtk(str(pt))
    np.testing.assert_array_equal(p3[:, 2], 0)


@pytest.mark.parametrize("kind", ["ram", "disk"])
def test_cell_manager_copy_behaves_as_the_original(rng, tmp_path, kind):
    pos, desc = _cloud(rng)
    desc.pop("stamp")
    cell = {"positions": pos, **desc}
    for mod, sub in ((jcm, "j"), (tcm, "t")):
        mgr = (mod.RAMCellManager() if kind == "ram"
               else mod.HardDriveCellManager(str(tmp_path / sub)))
        assert mgr.get_all_cell_ids() == []
        mgr.save_cell("1_-2_0", cell)
        mgr.save_cell("3_4_5", cell)
        assert sorted(mgr.get_all_cell_ids()) == ["1_-2_0", "3_4_5"]
        got = mgr.retrieve_cell("1_-2_0")
        np.testing.assert_allclose(got["positions"], pos, rtol=1e-6)
        np.testing.assert_allclose(got["normals"], desc["normals"], rtol=1e-6)
        assert mgr.retrieve_cell("9_9_9") is None
        mgr.remove_cell("1_-2_0")
        assert mgr.get_all_cell_ids() == ["3_4_5"]
        mgr.clear_all_cells()
        assert mgr.get_all_cell_ids() == []


def test_trajectory_copy_round_trips(tmp_path):
    stamps = [1_760_000_000_123_456_789, 1_760_000_000_223_456_790]
    for mod in (nj, nt):
        traj = mod.Trajectory(3)
        for i, s in enumerate(stamps):
            pose = np.eye(4, dtype=np.float32)
            pose[:3, 3] = [i, 2 * i, -i]
            traj.add_pose(pose, s)
        path = str(tmp_path / f"{mod.__name__}.vtk")
        traj.save(path)
        back = nt.Trajectory.load(path)
        assert back.timestamps == stamps  # exact nanoseconds
        np.testing.assert_array_equal(back.positions(), traj.positions())
    t = nt.Trajectory(3)
    t.add_pose(torch.eye(4), 5)  # a CPU tensor is accepted and copied
    assert t.poses[0].dtype == np.float32 and len(t) == 1
    t.clear()
    assert len(t) == 0 and t.positions().shape == (0, 3)


# ----------------------------------------------------------------- devices

def test_entry_points_default_to_the_card_and_raise_without_one():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    pts = np.zeros((4, 3), np.float32)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        nt.Mapper(None)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        nt.PointBatch.from_numpy(pts)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        nt.PointBatch.empty(8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        convert.point_batch_from_numpy(pts, np.ones(4, bool))
    assert nt.Mapper(None, device="cpu").device.type == "cpu"


def test_cpu_tensors_take_the_plain_path_and_launch_nothing(rng):
    q = torch.from_numpy(rng.normal(size=(200, 3)).astype(np.float32))
    s0, p0 = nn_sweep.sweep_knn.launches, pca.radius_pca.launches
    d, i, ov = nn_sweep.sweep_knn(q, q, k=2, max_radius=1.0, q_tile=128)
    cnt, _, _, _ = pca.radius_pca(q, q, max_radius=1.0)
    assert (nn_sweep.sweep_knn.launches, pca.radius_pca.launches) == (s0, p0)
    assert bool((i[:, 0] == torch.arange(200)).all())  # self match first
    assert bool((cnt >= 1).all())


def test_kernel_wrappers_refuse_what_the_kernel_does_not_take():
    q = torch.zeros(128, 3)
    m = torch.ones(128, dtype=torch.bool)
    z = torch.zeros(1, dtype=torch.int64)
    # a CPU tensor never reaches a launch: the checks come first
    r4 = torch.zeros(128, 4)  # the sorted references as the kernel reads them
    with pytest.raises(ValueError, match="CUDA tensors"):
        nn_sweep._search_kernel(q, m, r4, z, z, 1.0, 1, 128, 128)
    with pytest.raises(ValueError, match="1 <= k <= 6"):
        nn_sweep._search_kernel(q, m, r4, z, z, 1.0, 7, 128, 128)
    pack = nn_sweep.presort_ref(q, m)
    with pytest.raises(ValueError, match="CUDA tensors"):
        pca._stats_kernel(pack, pack, 1.0, 1.0, 1024, 128, 0)
    with pytest.raises(ValueError, match="D in"):
        pca._stats_kernel(pack._replace(center=torch.zeros(4)), pack, 1.0,
                          1.0, 1024, 128, 0)
    with pytest.raises(ValueError, match="multiple of 32"):
        pca._stats_kernel(pack, pack, 1.0, 1.0, 100, 128, 0)
    with pytest.raises(ValueError, match=r"f32\[M, 4\]"):
        pca._stats_kernel(pack._replace(ref_s=q), pack, 1.0, 1.0, 1024, 128,
                          0)
    with pytest.raises(ValueError, match="CUDA tensors"):
        eigen._eig_kernel(torch.zeros(5, 3, 3), 3)
    with pytest.raises(ValueError, match="float32"):
        eigen._eig_kernel(torch.zeros(5, 3, 3, dtype=torch.float64), 3)
    with pytest.raises(ValueError, match=r"\[..., 2, 2\]"):
        eigen._eig_kernel(torch.zeros(5, 3, 3), 2)
    with pytest.raises(ValueError, match="float32"):
        nn_sweep._search_kernel(q.double(), m, r4, z, z, 1.0, 1, 128, 128)
    with pytest.raises(ValueError, match=r"f32\[M, 4\]"):
        nn_sweep._search_kernel(q, m, q, z, z, 1.0, 1, 128, 128)
    with pytest.raises(ValueError, match="multiple of 128"):
        nn_sweep._kernel_block_for(100)
    with pytest.raises(ValueError, match="multiple of 256"):
        nn_sweep._kernel_block_for(128, nn_sweep._BLOCK_QUERIES)


# ----------------------------------------------------------------- convert

def test_convert_keeps_full_capacity_arrays_bit_for_bit(rng):
    pos = rng.normal(size=(64, 3)).astype(np.float32)
    mask = rng.random(64) < 0.5
    desc = {"normals": rng.normal(size=(64, 3)).astype(np.float32),
            "w": rng.random(64).astype(np.float32)}
    b = convert.point_batch_from_numpy(pos, mask, desc, device="cpu")
    np.testing.assert_array_equal(b.positions.numpy(), pos)  # padding too
    np.testing.assert_array_equal(b.mask.numpy(), mask)
    assert b.descriptors["w"].shape == (64, 1)
    with pytest.raises(ValueError, match="rows"):
        convert.point_batch_from_numpy(pos, mask, {"x": np.zeros(3)},
                                       device="cpu")


def test_convert_presort_pack(rng):
    import jax.numpy as jnp
    from norlab_icp_mapper_tpu.ops.nn_sweep import presort_ref as jpresort
    ref = rng.uniform(-5, 5, (300, 3)).astype(np.float32)
    rm = rng.random(300) > 0.2
    six = [np.asarray(x) for x in jpresort(jnp.asarray(ref), jnp.asarray(rm))]
    pack = convert.presort_pack_from_numpy(*six, device="cpu")
    assert int(pack.n_valid) == int(rm.sum())
    # the sorted coordinates, and the sort order as the fourth lane's bits
    np.testing.assert_array_equal(pack.ref_s.numpy()[:, :3], six[0])
    np.testing.assert_array_equal(pack.ref_s.numpy().view(np.int32)[:, 3],
                                  six[3])
    q = torch.from_numpy(rng.uniform(-5, 5, (100, 3)).astype(np.float32))
    kw = dict(k=2, max_radius=1.5, q_tile=128, W=300)
    d0, i0, _ = nn_sweep.sweep_knn(q, torch.from_numpy(ref), None,
                                   torch.from_numpy(rm), **kw)
    d1, i1, _ = nn_sweep.sweep_knn(q, torch.from_numpy(ref), None,
                                   torch.from_numpy(rm), presorted=pack, **kw)
    np.testing.assert_array_equal(i0.numpy(), i1.numpy())
    np.testing.assert_allclose(d0.numpy(), d1.numpy(), rtol=1e-5, atol=1e-6)


def test_cell_binning_and_collection_match_reference(rng):
    from norlab_icp_mapper_tpu import map as jmap
    from norlab_icp_mapper_tpu_torch import map as tmap
    assert (tmap.CELL_SIZE, tmap.BUFFER_SIZE) == (jmap.CELL_SIZE,
                                                  jmap.BUFFER_SIZE)
    pos = rng.uniform(-50, 50, size=(400, 3)).astype(np.float32)
    evict = {"positions": pos,
             "normals": rng.normal(size=(400, 3)).astype(np.float32)}
    mj, mt = jcm.RAMCellManager(), tcm.RAMCellManager()
    for half in (slice(0, 200), slice(200, 400)):  # a re-save merges
        part = {k: v[half] for k, v in evict.items()}
        jmap.bin_points_to_cells(part, mj, 3)
        tmap.bin_points_to_cells(part, mt, 3)
    assert sorted(mj.get_all_cell_ids()) == sorted(mt.get_all_cell_ids())
    for cid in mj.get_all_cell_ids():
        a, b = mj.retrieve_cell(cid), mt.retrieve_cell(cid)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
    bounds = (-2, 1, -3, 0, -1, 2)
    dj, ids_j = jmap.collect_cells_in_bounds(mj, bounds, 3, remove=True)
    dt, ids_t = tmap.collect_cells_in_bounds(mt, bounds, 3, remove=True)
    assert sorted(ids_j) == sorted(ids_t) and len(ids_t) > 0
    oj, ot = np.lexsort(dj["positions"].T), np.lexsort(dt["positions"].T)
    np.testing.assert_array_equal(dj["positions"][oj], dt["positions"][ot])
    np.testing.assert_array_equal(dj["normals"][oj], dt["normals"][ot])
    assert sorted(mj.get_all_cell_ids()) == sorted(mt.get_all_cell_ids())
    none, ids = tmap.collect_cells_in_bounds(mt, (90, 91, 0, 0, 0, 0), 3)
    assert none is None and ids == []
