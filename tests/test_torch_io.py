"""The port's file IO against the JAX package's, on the same files: each
reader reads the other package's writer's output, both ways, and the decoded
arrays are equal bit for bit (PLY, CSV, PCD ASCII and binary with NaN rows
and mixed field types, the trajectory CSV, the dispatchers, the native VTK
bridge against the numpy parser and against the JAX reader)."""
import os

import numpy as np
import pytest

from norlab_icp_mapper_tpu import io as jio
from norlab_icp_mapper_tpu.io import vtk as jvtk
from norlab_icp_mapper_tpu_torch import io as tio
from norlab_icp_mapper_tpu_torch.io import native as tnative, vtk as tvtk

from test_vtk_binary_and_traj import _write_binary_vtk


def cloud(rng, n=57, dim=3):
    pos = rng.normal(scale=5.0, size=(n, dim)).astype(np.float32)
    desc = {
        "normals": rng.normal(size=(n, 3)).astype(np.float32),
        "intensity": rng.uniform(size=(n, 1)).astype(np.float32),
        "rgb": rng.uniform(0, 255, size=(n, 2)).astype(np.float32),
    }
    return pos, desc


def assert_same(a, b):
    """Two decoded clouds equal bit for bit: positions, descriptor names,
    dtypes and values."""
    (pa, da), (pb, db) = a, b
    assert pa.dtype == pb.dtype and pa.shape == pb.shape
    np.testing.assert_array_equal(pa, pb)
    assert sorted(da) == sorted(db)
    for k in da:
        assert da[k].dtype == db[k].dtype, k
        np.testing.assert_array_equal(da[k], db[k])


WRITERS = {
    "ply": (jio.write_ply, tio.write_ply),
    "csv": (jio.write_csv_cloud, tio.write_csv_cloud),
    "pcd_ascii": (jio.write_pcd, tio.write_pcd),
    "pcd_binary": (lambda p, x, d: jio.write_pcd(p, x, d, binary=True),
                   lambda p, x, d: tio.write_pcd(p, x, d, binary=True)),
}
READERS = {"ply": (jio.read_ply, tio.read_ply),
           "csv": (jio.read_csv_cloud, tio.read_csv_cloud),
           "pcd_ascii": (jio.read_pcd, tio.read_pcd),
           "pcd_binary": (jio.read_pcd, tio.read_pcd)}


@pytest.mark.parametrize("fmt", sorted(WRITERS))
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_each_reader_reads_the_other_writer(tmp_path, rng, fmt, writer):
    pos, desc = cloud(rng)
    ext = fmt.split("_")[0]
    path = str(tmp_path / f"c.{ext}")
    WRITERS[fmt][0 if writer == "jax" else 1](path, pos, desc)
    read_j, read_t = READERS[fmt]
    got_j, got_t = read_j(path), read_t(path)
    assert_same(got_t, got_j)
    assert got_t[0].shape == pos.shape
    if fmt == "pcd_binary":  # binary float32 is lossless
        np.testing.assert_array_equal(got_t[0], pos)


@pytest.mark.parametrize("fmt", sorted(WRITERS))
def test_both_writers_write_the_same_values(tmp_path, rng, fmt):
    """The files differ at most in the comment naming the package."""
    pos, desc = cloud(rng)
    ext = fmt.split("_")[0]
    pj, pt = str(tmp_path / f"j.{ext}"), str(tmp_path / f"t.{ext}")
    WRITERS[fmt][0](pj, pos, desc)
    WRITERS[fmt][1](pt, pos, desc)
    assert_same(READERS[fmt][1](pt), READERS[fmt][1](pj))
    with open(pj, "rb") as fj, open(pt, "rb") as ft:
        lj = [ln for ln in fj.read().split(b"\n") if b"created by" not in ln]
        lt = [ln for ln in ft.read().split(b"\n") if b"created by" not in ln]
    assert lj == lt


def _mixed_pcd(path, rng, binary, n=40):
    """A lidar-style PCD: float x y z, a uint16 ring, an int8 label, a
    float64 time, a two-count field, normals; every fifth row NaN."""
    fields = [("x", "F", 4, 1), ("y", "F", 4, 1), ("z", "F", 4, 1),
              ("ring", "U", 2, 1), ("label", "I", 1, 1), ("t", "F", 8, 1),
              ("pair", "F", 4, 2), ("normal_x", "F", 4, 1),
              ("normal_y", "F", 4, 1), ("normal_z", "F", 4, 1)]
    np_types = {("F", 4): "<f4", ("F", 8): "<f8", ("U", 2): "<u2",
                ("I", 1): "i1"}
    dt = []
    for name, ty, sz, cnt in fields:
        dt.append((name, np_types[(ty, sz)]) if cnt == 1
                  else (name, np_types[(ty, sz)], (cnt,)))
    rec = np.zeros(n, dtype=dt)
    for c in "xyz":
        rec[c] = rng.normal(scale=3.0, size=n)
    rec["x"][::5] = np.nan
    rec["ring"] = rng.integers(0, 64, n)
    rec["label"] = rng.integers(-100, 100, n)
    rec["t"] = rng.uniform(0, 1, n)
    rec["pair"] = rng.normal(size=(n, 2))
    for c in ("normal_x", "normal_y", "normal_z"):
        rec[c] = rng.normal(size=n)
    head = ("# .PCD v0.7\nVERSION 0.7\n"
            f"FIELDS {' '.join(f[0] for f in fields)}\n"
            f"SIZE {' '.join(str(f[2]) for f in fields)}\n"
            f"TYPE {' '.join(f[1] for f in fields)}\n"
            f"COUNT {' '.join(str(f[3]) for f in fields)}\n"
            f"WIDTH {n}\nHEIGHT 1\nVIEWPOINT 0 0 0 1 0 0 0\nPOINTS {n}\n"
            f"DATA {'binary' if binary else 'ascii'}\n")
    with open(path, "wb") as f:
        f.write(head.encode())
        if binary:
            f.write(rec.tobytes())
        else:
            for r in rec:
                vals = []
                for name, _, _, cnt in fields:
                    v = r[name]
                    vals += [repr(float(x)) for x in np.ravel(v)]
                f.write((" ".join(vals) + "\n").encode())
    return rec


@pytest.mark.parametrize("binary", [False, True], ids=["ascii", "binary"])
def test_pcd_nan_rows_and_mixed_types(tmp_path, rng, binary):
    path = str(tmp_path / "m.pcd")
    rec = _mixed_pcd(path, rng, binary)
    got_t, got_j = tio.read_pcd(path), jio.read_pcd(path)
    assert_same(got_t, got_j)
    pos, desc = got_t
    keep = ~np.isnan(rec["x"])
    assert pos.shape == (int(keep.sum()), 3)
    np.testing.assert_array_equal(desc["ring"][:, 0],
                                  rec["ring"][keep].astype(np.float32))
    np.testing.assert_array_equal(desc["label"][:, 0],
                                  rec["label"][keep].astype(np.float32))
    assert desc["normals"].shape == (pos.shape[0], 3)
    assert desc["pair_1"].shape == (pos.shape[0], 1)


def test_pcd_refuses_what_it_does_not_read(tmp_path):
    for body, what in [("TYPE F F F\nSIZE 2 4 4", "unsupported PCD field"),
                       ("TYPE F F F\nSIZE 4 4 4", "binary_compressed")]:
        path = str(tmp_path / "bad.pcd")
        enc = "binary_compressed" if "compressed" in what else "ascii"
        with open(path, "w") as f:
            f.write(f"VERSION 0.7\nFIELDS x y z\n{body}\nCOUNT 1 1 1\n"
                    f"WIDTH 1\nHEIGHT 1\nPOINTS 1\nDATA {enc}\n1 2 3\n")
        for read in (jio.read_pcd, tio.read_pcd):
            with pytest.raises(ValueError, match=what):
                read(path)


TRAJ_HEADER = ("header.stamp.sec,header.stamp.nanosec,header.frame_id,"
               "pose.pose.position.x,pose.pose.position.y,"
               "pose.pose.position.z,pose.pose.orientation.x,"
               "pose.pose.orientation.y,pose.pose.orientation.z,"
               "pose.pose.orientation.w,twist.twist.linear.x\n")


def write_trajectory_csv(path, poses_xyz_quat, stamps_ns):
    with open(path, "w") as f:
        f.write(TRAJ_HEADER)
        for (t, q), ns in zip(poses_xyz_quat, stamps_ns):
            vals = ",".join(repr(float(v)) for v in (*t, *q))
            f.write(f"{ns // 10**9},{ns % 10**9},map,{vals},0.5\n")


def test_trajectory_csv(tmp_path, rng):
    rows = []
    for _ in range(7):
        q = rng.normal(size=4)
        q *= 1.3 / np.linalg.norm(q)  # not unit: the reader normalises
        rows.append((rng.normal(scale=20, size=3), q))
    stamps = [1_690_309_709_285_305_600 + i * 99_999_999 for i in range(7)]
    path = str(tmp_path / "icp_odom.csv")
    write_trajectory_csv(path, rows, stamps)
    got_t, got_j = tio.read_trajectory_csv(path), jio.read_trajectory_csv(path)
    assert len(got_t) == len(got_j) == 7
    for (Tt, st), (Tj, sj), ns in zip(got_t, got_j, stamps):
        assert Tt.dtype == np.float32
        np.testing.assert_array_equal(Tt, Tj)
        assert st == sj == ns and isinstance(st, int)
        R = Tt[:3, :3].astype(np.float64)
        np.testing.assert_allclose(R @ R.T, np.eye(3), atol=1e-6)


@pytest.mark.parametrize("ext", ["vtk", "ply", "csv", "pcd"])
def test_dispatchers(tmp_path, rng, ext):
    pos, desc = cloud(rng)
    pt, pj = str(tmp_path / f"t.{ext.upper()}"), str(tmp_path / f"j.{ext}")
    tio.write_point_cloud(pt, pos, desc)
    jio.write_point_cloud(pj, pos, desc)
    for path in (pt, pj):
        assert_same(tio.read_point_cloud(path), jio.read_point_cloud(path))


def test_dispatchers_refuse_an_unknown_extension(tmp_path, rng):
    pos, desc = cloud(rng)
    path = str(tmp_path / "c.xyz")
    for pkg in (tio, jio):
        with pytest.raises(ValueError, match="unsupported point cloud"):
            pkg.write_point_cloud(path, pos, desc)
        with pytest.raises(ValueError, match="unsupported point cloud"):
            pkg.read_point_cloud(path)


# ------------------------------------------------------------- native VTK

def _native_or_skip():
    lib = tnative._load()
    if lib is None:
        pytest.skip("g++ is unavailable: the native VTK bridge cannot build")
    return lib


def test_native_vtk_reader_equals_numpy_and_jax(tmp_path, rng, monkeypatch):
    _native_or_skip()
    pos, desc = cloud(rng, n=513)
    path = str(tmp_path / "c.vtk")
    jvtk.write_vtk(path, pos, desc)
    native = tnative.read_vtk_native(path)
    assert native is not None
    assert_same(tvtk.read_vtk(path), native)  # read_vtk takes the native path
    assert_same(jvtk.read_vtk(path), native)
    monkeypatch.setattr(tnative, "_tried", True)
    monkeypatch.setattr(tnative, "_lib", None)
    assert_same(tvtk.read_vtk(path), native)  # the numpy parser


def test_native_vtk_writer_writes_the_numpy_writers_bytes(tmp_path, rng,
                                                          monkeypatch):
    _native_or_skip()
    for dim in (3, 2):
        pos, desc = cloud(rng, n=301, dim=dim)
        pn, pp = str(tmp_path / "n.vtk"), str(tmp_path / "p.vtk")
        assert tnative.write_vtk_native(pn, pos, desc)
        with monkeypatch.context() as m:
            m.setattr(tnative, "_tried", True)
            m.setattr(tnative, "_lib", None)
            tvtk.write_vtk(pp, pos, desc)
        with open(pn, "rb") as a, open(pp, "rb") as b:
            assert a.read() == b.read()
        assert_same(jvtk.read_vtk(pn), tvtk.read_vtk(pn))


def test_native_library_is_built_in_the_port_build_dir():
    _native_or_skip()
    lib = tnative.library_path()
    assert lib.is_file()
    assert lib.parent.name == "build"
    assert lib.parent.parent.name == "norlab_icp_mapper_tpu_torch"


def test_double_sections_stay_on_numpy(tmp_path, rng):
    """The native reader and writer are float32-only: a file with a
    ``double`` section is written and read by numpy, losslessly."""
    pos, _ = cloud(rng, n=20)
    stamps = rng.uniform(0, 1e9, size=(20, 1))  # float64
    path = str(tmp_path / "d.vtk")
    tvtk.write_vtk(path, pos, {"t": stamps})
    with open(path, "rb") as f:
        assert b"SCALARS t double" in f.read()
    got = tvtk.read_vtk(path)
    assert got[1]["t"].dtype == np.float64
    np.testing.assert_array_equal(got[1]["t"], stamps)
    assert_same(got, jvtk.read_vtk(path))


def test_binary_vtk_is_read_alike(tmp_path, rng):
    n = 77
    pos = rng.normal(size=(n, 3)).astype(np.float32)
    path = str(tmp_path / "b.vtk")
    _write_binary_vtk(path, pos,
                      scalars=("probabilityDynamic",
                               rng.uniform(size=(n, 1)).astype(np.float32)),
                      normals=rng.normal(size=(n, 3)).astype(np.float32),
                      field=("extras", rng.normal(size=(n, 2))))
    got = tvtk.read_vtk(path)
    np.testing.assert_array_equal(got[0], pos)
    assert_same(got, jvtk.read_vtk(path))


def test_disable_switch_and_missing_compiler(tmp_path, rng, monkeypatch):
    """``NIM_TPU_DISABLE_NATIVE`` and a missing ``g++`` both leave the numpy
    parser in charge; the results do not change."""
    pos, desc = cloud(rng, n=40)
    path = str(tmp_path / "c.vtk")
    tvtk.write_vtk(path, pos, desc)
    expect = jvtk.read_vtk(path)
    monkeypatch.setattr(tnative, "_tried", False)
    monkeypatch.setattr(tnative, "_lib", None)
    monkeypatch.setenv("NIM_TPU_DISABLE_NATIVE", "1")
    assert tnative.read_vtk_native(path) is None
    assert tnative.write_vtk_native(str(tmp_path / "x.vtk"), pos) is False
    assert_same(tvtk.read_vtk(path), expect)

    monkeypatch.delenv("NIM_TPU_DISABLE_NATIVE")
    monkeypatch.setattr(tnative, "_tried", False)
    monkeypatch.setattr(tnative, "library_path",
                        lambda: tmp_path / "build" / "libvtk_fast-x.so")
    monkeypatch.setenv("PATH", str(tmp_path / "empty"))
    assert tnative._load() is None
    assert not (tmp_path / "build" / "libvtk_fast-x.so").exists()
    assert_same(tvtk.read_vtk(path), expect)
    assert os.listdir(tmp_path / "build") == []  # no temporary left behind
