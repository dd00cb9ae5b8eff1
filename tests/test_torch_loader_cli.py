"""The port's offline file entry point on the CPU: ``io.loader.ScanLoader``
(order, content, ``n_valid``, extras) and the CLI
``norlab_icp_mapper_tpu_torch.build_map`` on a 4-scan dataset written in all
four formats, against an in-memory port Mapper fed the decoded arrays (bit
for bit) and against the JAX package's example script on the same
directory (the tolerances of ``test_torch_mapper_e2e.py``'s own-draws
identity case)."""
import importlib.util
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from norlab_icp_mapper_tpu.io import write_pcd as jwrite_pcd
import norlab_icp_mapper_tpu_torch as nt
from norlab_icp_mapper_tpu_torch import build_map, io as tio
from norlab_icp_mapper_tpu_torch.io.loader import ScanLoader

from test_torch_io import write_trajectory_csv
from test_torch_mapper_e2e import (make_world, scan_at, voxel_agreement)

ROOT = pathlib.Path(__file__).resolve().parent.parent
CONFIG = str(ROOT / "examples" / "config.yaml")


@pytest.fixture(autouse=True)
def _pin_rematch(monkeypatch):
    monkeypatch.setenv("NIM_TPU_REMATCH_EVERY", "3")


def yaw_quat(yaw):
    return np.array([0.0, 0.0, np.sin(yaw / 2), np.cos(yaw / 2)])


def write_dataset(root, rng, xs=(2.0, 2.5, 3.0, 3.5)):
    """``scans/`` with one scan per format (VTK, PLY, CSV, binary PCD) and
    ``icp_odom.csv``; scans are cut from the corridor world at the poses
    the CSV decodes to, each at most 1024 points."""
    world = make_world(rng)
    scans = root / "scans"
    scans.mkdir(parents=True)
    rows = [(np.array([x, 0.1 * i, 0.0]), yaw_quat(0.02 * i))
            for i, x in enumerate(xs)]
    stamps = [1_690_309_709_000_000_000 + i * 100_000_000
              for i in range(len(xs))]
    write_trajectory_csv(str(root / "icp_odom.csv"), rows, stamps)
    poses = tio.read_trajectory_csv(str(root / "icp_odom.csv"))
    writers = [("vtk", tio.write_vtk), ("ply", tio.write_ply),
               ("csv", tio.write_csv_cloud),
               ("pcd", lambda p, x: jwrite_pcd(p, x, binary=True))]
    for i, ((ext, write), (pose, _)) in enumerate(zip(writers, poses)):
        scan = scan_at(world, pose)
        assert scan.shape[0] <= 1024
        write(str(scans / f"scan_{i:03d}.{ext}"), scan)
    return poses


def in_memory(data, out, device="cpu"):
    """The CLI's drive without files in the loop: a port Mapper fed the
    arrays the readers decode, outputs written with the same writers."""
    files = sorted(os.listdir(data / "scans"))
    poses = tio.read_trajectory_csv(str(data / "icp_odom.csv"))
    mapper = nt.Mapper(CONFIG, is_3d=True, is_online=False, is_mapping=True,
                       save_map_cells_on_hard_drive=False, device=device)
    for f, (pose, stamp) in zip(files, poses):
        pos, desc = tio.read_point_cloud(str(data / "scans" / f))
        batch = nt.PointBatch.from_numpy(pos, desc, device=device)
        mapper.process_input(mapper.apply_input_filters(batch), pose, stamp,
                             scan_valid_hint=pos.shape[0])
    mapper.drain()
    cloud = mapper.get_map()
    out.mkdir()
    tio.write_vtk(str(out / "map.vtk"), cloud["positions"],
                  {k: v for k, v in cloud.items() if k != "positions"})
    mapper.get_trajectory().save(str(out / "trajectory.vtk"))
    mapper.shutdown()
    return mapper


def same_bytes(a, b):
    with open(a, "rb") as fa, open(b, "rb") as fb:
        return fa.read() == fb.read()


# ------------------------------------------------------------- ScanLoader

def test_scan_loader_order_content_n_valid_and_extras(tmp_path, rng):
    paths, clouds = [], []
    for i, ext in enumerate(["vtk", "ply", "csv", "pcd", "vtk", "pcd"]):
        pos = rng.normal(size=(20 + 7 * i, 3)).astype(np.float32)
        desc = {"intensity": rng.uniform(size=(pos.shape[0], 1))
                .astype(np.float32)}
        p = str(tmp_path / f"s{i}.{ext}")
        tio.write_point_cloud(p, pos, desc)
        paths.append(p)
        clouds.append(tio.read_point_cloud(p))
    for capacity, prefetch, workers in [(None, 2, 2), (320, 4, 3),
                                        (None, 1, 1)]:
        loader = ScanLoader(paths, extras=[f"e{i}" for i in range(6)],
                            prefetch=prefetch, capacity=capacity,
                            workers=workers, device="cpu")
        assert len(loader) == 6
        seen = list(loader)
        loader.close()
        assert [e for _, _, e in seen] == [f"e{i}" for i in range(6)]
        assert [n for _, n, _ in seen] == [20 + 7 * i for i in range(6)]
        for (batch, n, _), (pos, desc) in zip(seen, clouds):
            assert batch.device == torch.device("cpu")
            assert batch.capacity == (capacity or nt.bucket_capacity(n))
            ref = nt.PointBatch.from_numpy(pos, desc, capacity=capacity,
                                           device="cpu")
            assert torch.equal(batch.positions, ref.positions)
            assert torch.equal(batch.mask, ref.mask)
            assert sorted(batch.descriptors) == ["intensity"]
            assert torch.equal(batch.descriptors["intensity"],
                               ref.descriptors["intensity"])


def test_scan_loader_without_extras_and_refusals(tmp_path, rng):
    p = str(tmp_path / "a.vtk")
    tio.write_vtk(p, rng.normal(size=(5, 3)).astype(np.float32))
    loader = ScanLoader([p, p], device="cpu")
    assert [e for _, _, e in loader] == [None, None]
    loader.close()
    with pytest.raises(ValueError, match="extras"):
        ScanLoader([p, p], extras=[1], device="cpu")


def test_entry_points_default_to_the_card(tmp_path, rng):
    """Without ``device`` the loader and the CLI ask for the card, and
    raise on a machine without one (this one)."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    write_dataset(tmp_path, rng)
    with pytest.raises(RuntimeError, match="cuda"):
        ScanLoader([str(tmp_path / "scans" / "scan_000.vtk")])
    with pytest.raises(RuntimeError, match="cuda"):
        build_map.main(str(tmp_path), CONFIG, str(tmp_path / "out"),
                       verbose=False)


# -------------------------------------------------------------------- CLI

def test_cli_equals_an_in_memory_mapper_bit_for_bit(tmp_path, rng, capsys):
    write_dataset(tmp_path / "data", rng)
    mapper, per_scan = build_map.main(str(tmp_path / "data"), CONFIG,
                                      str(tmp_path / "cli"), device="cpu")
    printed = capsys.readouterr().out
    assert len(per_scan) == 4
    assert "scan_003.pcd:" in printed and "scans/s" in printed
    ref = in_memory(tmp_path / "data", tmp_path / "mem")
    for name in ("map.vtk", "trajectory.vtk"):
        assert same_bytes(tmp_path / "cli" / name, tmp_path / "mem" / name)
    got, want = mapper.get_map(), ref.get_map()
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    assert got["positions"].shape[0] > 500
    assert len(mapper.get_trajectory()) == 4


def test_cli_refuses_a_count_mismatch(tmp_path, rng):
    write_dataset(tmp_path, rng)
    os.remove(tmp_path / "scans" / "scan_003.pcd")
    with pytest.raises(ValueError, match="scan count 3 != trajectory rows 4"):
        build_map.main(str(tmp_path), CONFIG, device="cpu", verbose=False)


def test_cli_as_a_module(tmp_path, rng):
    """``python -m norlab_icp_mapper_tpu_torch.build_map ... --device cpu``
    writes what ``main`` writes; without ``--device`` it wants the card."""
    write_dataset(tmp_path / "data", rng)
    build_map.main(str(tmp_path / "data"), CONFIG, str(tmp_path / "main"),
                   device="cpu", verbose=False)
    cmd = [sys.executable, "-m", "norlab_icp_mapper_tpu_torch.build_map",
           str(tmp_path / "data"), CONFIG, str(tmp_path / "cli")]
    env = dict(os.environ, NIM_TPU_REMATCH_EVERY="3")
    out = subprocess.run(cmd + ["--device", "cpu"], capture_output=True,
                         text=True, cwd=str(ROOT), env=env, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "4 scans in" in out.stdout
    for name in ("map.vtk", "trajectory.vtk"):
        assert same_bytes(tmp_path / "cli" / name, tmp_path / "main" / name)
    if not torch.cuda.is_available():
        out = subprocess.run(cmd, capture_output=True, text=True,
                             cwd=str(ROOT), env=env, timeout=300)
        assert out.returncode != 0 and "torch.cuda.is_available()" \
            in out.stderr


def _jax_example():
    spec = importlib.util.spec_from_file_location(
        "jax_build_map",
        ROOT / "examples" / "build_map_from_scans_and_trajectory.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_cli_against_the_jax_example(tmp_path, rng):
    """The same directory through the JAX example script's ``main`` and the
    port's: trajectories within 1e-5 (the identity minimizer returns the
    priors), map counts within 2 % and occupied 0.15 m voxels agreeing to
    98 % (each package draws its own voxel representatives)."""
    write_dataset(tmp_path / "data", rng)
    mt, _ = build_map.main(str(tmp_path / "data"), CONFIG,
                           str(tmp_path / "port"), device="cpu",
                           verbose=False)
    mj, _ = _jax_example().main(str(tmp_path / "data"), CONFIG,
                               str(tmp_path / "jax"), verbose=False)
    pj, pt = mj.get_trajectory().poses, mt.get_trajectory().poses
    assert len(pj) == len(pt) == 4
    for a, b in zip(pj, pt):
        np.testing.assert_allclose(b, a, atol=1e-5)
    # the files each of them wrote, read by the port
    gj = tio.read_vtk(str(tmp_path / "jax" / "map.vtk"))[0]
    gt = tio.read_vtk(str(tmp_path / "port" / "map.vtk"))[0]
    assert abs(len(gj) - len(gt)) <= 0.02 * max(len(gj), len(gt))
    assert voxel_agreement(gj, gt) >= 0.98
    tj = tio.read_vtk(str(tmp_path / "jax" / "trajectory.vtk"))
    tt = tio.read_vtk(str(tmp_path / "port" / "trajectory.vtk"))
    np.testing.assert_allclose(tt[0], tj[0], atol=1e-5)
    assert sorted(tt[1]) == sorted(tj[1])
