"""The port's host-side copies against the reference: recorded streams,
the config's JSON, and the .pcd / .ply / planes.txt files, which must be
byte-identical to the reference's for the same input."""

import threading

import pytest

pytest.importorskip("jax")

import numpy as np
import torch

from housescan_tpu.config import Config as JConfig
from housescan_tpu.io import pcd as j_pcd
from housescan_tpu.io import planes_txt as j_planes_txt
from housescan_tpu.io import ply as j_ply
from housescan_tpu.capture import replay as j_replay
from housescan_tpu.geometry.plane import PlaneEq as JPlaneEq
from housescan_tpu.kinfu.camera import Intrinsics as JIntrinsics
from housescan_tpu_torch.capture.replay import (
    PrefetchingSource,
    ReplaySource,
    depth_frame_to_cloud,
    load_stream,
    record_stream,
)
from housescan_tpu_torch.config import Config, IcpConfig, TsdfConfig
from housescan_tpu_torch.geometry.plane import PlaneEq
from housescan_tpu_torch.io import pcd, planes_txt, ply
from housescan_tpu_torch.kinfu.camera import Intrinsics
from housescan_tpu_torch.kinfu.synthetic import furnished_room, orbit_poses, render_depth_stream

INTR = Intrinsics(width=160, height=120, fx=131.25, fy=131.25, cx=79.5, cy=59.5)


@pytest.fixture(scope="module")
def stream_file(tmp_path_factory):
    half, boxes = furnished_room()
    poses = orbit_poses(5, radius=0.25, yaw_range=0.1, pitch=0.25)
    frames = render_depth_stream(INTR, poses, half, boxes, device="cpu")
    path = tmp_path_factory.mktemp("streams") / "scan.npz"
    record_stream(path, frames, INTR, poses=poses)
    return path, frames.numpy(), poses


def test_stream_round_trip_and_reference_load(stream_file):
    """uint16 mm quantization: 0.5 mm; the reference loads the port's
    file with the same frames (its decode multiplies the same way)."""
    path, frames, poses = stream_file
    stream = load_stream(path)
    assert stream.intrinsics == INTR
    np.testing.assert_allclose(stream.frames, frames, atol=6e-4)
    np.testing.assert_array_equal(stream.poses, poses)
    ref = j_replay.load_stream(path)
    assert tuple(ref.intrinsics) == tuple(INTR)
    np.testing.assert_allclose(stream.frames, ref.frames, rtol=1e-6)


def test_reference_stream_loads_in_port(stream_file, tmp_path):
    _, frames, poses = stream_file
    j_replay.record_stream(tmp_path / "ref.npz", frames, JIntrinsics(*INTR), poses=poses)
    stream = load_stream(tmp_path / "ref.npz")
    assert stream.intrinsics == INTR and len(stream) == len(frames)
    np.testing.assert_allclose(stream.frames, frames, atol=6e-4)


def test_replay_and_prefetch_sources(stream_file):
    path, frames, _ = stream_file
    src = ReplaySource.open(path)
    assert src.intrinsics == INTR
    n = 0
    while src.read() is not None:
        n += 1
    assert n == len(frames) and src.read() is None
    pre = PrefetchingSource(ReplaySource.open(path), depth=2)
    got = []
    while (f := pre.read()) is not None:
        got.append(f)
    assert len(got) == len(frames)
    np.testing.assert_allclose(got[-1], frames[-1], atol=6e-4)
    pre.close()
    assert not pre._thread.is_alive()


def test_prefetch_many_concurrent_streams_and_close(stream_file):
    """Eight prefetchers drained in parallel, and one closed undrained."""
    path, frames, _ = stream_file
    counts, lock = [], threading.Lock()

    def drain():
        src = PrefetchingSource(ReplaySource.open(path), depth=1)
        k = 0
        while src.read() is not None:
            k += 1
        with lock:
            counts.append(k)

    threads = [threading.Thread(target=drain) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert counts == [len(frames)] * 8
    stuck = PrefetchingSource(ReplaySource.open(path), depth=1)
    stuck.close()
    assert not stuck._thread.is_alive()


def test_depth_frame_to_cloud_matches_reference(stream_file):
    _, frames, _ = stream_file
    got = depth_frame_to_cloud(frames[0], INTR)
    want = j_replay.depth_frame_to_cloud(frames[0], JIntrinsics(*INTR))
    assert got.shape == want.shape == ((frames[0] > 0).sum(), 3)
    np.testing.assert_allclose(got, want, atol=1e-6)


def test_config_json_round_trips_with_reference():
    cfg = Config(tsdf=TsdfConfig(resolution=256, trunc_dist=0.04),
                 icp=IcpConfig(iterations=(6, 3, 2)))
    assert Config.from_json(cfg.to_json()) == cfg
    ref = JConfig.from_json(cfg.to_json())
    assert ref.to_json() == cfg.to_json()
    assert Config.from_json(JConfig().to_json()) == Config()


@pytest.mark.parametrize("binary", [True, False])
def test_pcd_bytes_match_reference(tmp_path, binary):
    rng = np.random.default_rng(0)
    cloud = pcd.PointCloud(points=rng.normal(size=(50, 3)).astype(np.float32),
                           colors=rng.uniform(size=(50, 3)).astype(np.float32),
                           normals=rng.normal(size=(50, 3)).astype(np.float32))
    pcd.save_pcd(tmp_path / "port.pcd", cloud, binary=binary)
    j_pcd.save_pcd(tmp_path / "ref.pcd", j_pcd.PointCloud(cloud.points, cloud.colors, cloud.normals),
                   binary=binary)
    assert (tmp_path / "port.pcd").read_bytes() == (tmp_path / "ref.pcd").read_bytes()
    back = pcd.load_pcd(tmp_path / "ref.pcd")
    np.testing.assert_array_equal(back.points, cloud.points)
    np.testing.assert_allclose(back.colors, cloud.colors, atol=1 / 255)


@pytest.mark.parametrize("binary", [True, False])
def test_ply_bytes_match_reference(tmp_path, binary):
    rng = np.random.default_rng(1)
    v = rng.normal(size=(30, 3)).astype(np.float32)
    f = np.arange(30, dtype=np.int32).reshape(-1, 3)
    ply.save_ply(tmp_path / "port.ply", ply.Mesh(vertices=v, faces=f), binary=binary)
    j_ply.save_ply(tmp_path / "ref.ply", j_ply.Mesh(vertices=v, faces=f), binary=binary)
    assert (tmp_path / "port.ply").read_bytes() == (tmp_path / "ref.ply").read_bytes()
    back = ply.load_ply(tmp_path / "ref.ply")
    np.testing.assert_array_equal(back.faces, f)
    np.testing.assert_allclose(back.vertices, v, atol=0 if binary else 1e-6)


def test_planes_txt_bytes_match_reference(tmp_path):
    rng = np.random.default_rng(2)
    n = rng.normal(size=(4, 3)).astype(np.float32)
    n /= np.linalg.norm(n, axis=1, keepdims=True)
    d = rng.normal(size=4).astype(np.float32)
    planes_txt.save_planes_txt(tmp_path / "port.txt", PlaneEq(torch.from_numpy(n), torch.from_numpy(d)))
    j_planes_txt.save_planes_txt(tmp_path / "ref.txt", JPlaneEq(n, d))
    assert (tmp_path / "port.txt").read_bytes() == (tmp_path / "ref.txt").read_bytes()
    back = planes_txt.load_planes_txt(tmp_path / "ref.txt")
    np.testing.assert_allclose(back.normal.numpy(), n, atol=1e-6)
    np.testing.assert_allclose(back.d.numpy(), d, atol=1e-6)
    with pytest.raises(planes_txt.PlanesTxtError):
        (tmp_path / "bad.txt").write_text("1 2 3\n")
        planes_txt.load_planes_txt(tmp_path / "bad.txt")


class TestXf:
    """Twins of the reference's .xf tests, and byte parity with its writer."""

    def test_round_trip(self, tmp_path):
        from housescan_tpu_torch.io.xf import load_xf, save_xf

        m = np.eye(4)
        m[:3, :3] = np.array([[0, 1, 0], [-1, 0, 0], [0, 0, 1]])
        m[3, :3] = [1.5, -2.0, 3.25]
        save_xf(tmp_path / "r.xf", m)
        np.testing.assert_allclose(load_xf(tmp_path / "r.xf"), m)
        # a tensor on any device goes through the same writer
        save_xf(tmp_path / "t.xf", torch.from_numpy(m.astype(np.float32)))
        np.testing.assert_allclose(load_xf(tmp_path / "t.xf"), m)

    def test_file_is_column_vector_convention(self, tmp_path):
        from housescan_tpu_torch.io.xf import save_xf

        m = np.eye(4)
        m[3, :3] = [7.0, 8.0, 9.0]
        save_xf(tmp_path / "t.xf", m)
        rows = [[float(v) for v in line.split()]
                for line in (tmp_path / "t.xf").read_text().splitlines()]
        assert [r[3] for r in rows[:3]] == [7.0, 8.0, 9.0]

    def test_malformed_raises(self, tmp_path):
        from housescan_tpu_torch.io.xf import load_xf

        (tmp_path / "s.xf").write_text("1 2 3\n")
        with pytest.raises(ValueError):
            load_xf(tmp_path / "s.xf")

    def test_bytes_match_reference(self, tmp_path):
        from housescan_tpu.io.xf import load_xf as j_load, save_xf as j_save
        from housescan_tpu_torch.io.xf import load_xf, save_xf

        m = np.random.default_rng(0).normal(size=(4, 4)).astype(np.float32)
        save_xf(tmp_path / "p.xf", m)
        j_save(tmp_path / "j.xf", m)
        assert (tmp_path / "p.xf").read_bytes() == (tmp_path / "j.xf").read_bytes()
        np.testing.assert_array_equal(load_xf(tmp_path / "j.xf"), j_load(tmp_path / "p.xf"))
