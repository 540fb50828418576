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


class TestBinaryCompressed:
    """Twins of tests/test_io.py's binary_compressed tests, then the file
    against the reference's: byte-identical when both packages take the
    same codec route (native against native, Python against Python)."""

    def test_binary_compressed_round_trip(self, tmp_path):
        rng = np.random.default_rng(0)
        pc = pcd.PointCloud(
            points=rng.normal(size=(500, 3)).astype(np.float32),
            colors=rng.uniform(size=(500, 3)).astype(np.float32),
            normals=rng.normal(size=(500, 3)).astype(np.float32),
        )
        pcd.save_pcd(tmp_path / "z.pcd", pc, compressed=True)
        raw = (tmp_path / "z.pcd").read_bytes()
        assert b"DATA binary_compressed" in raw
        hdr_end = raw.index(b"binary_compressed\n") + len(b"binary_compressed\n")
        comp, uncomp = np.frombuffer(raw[hdr_end : hdr_end + 8], "<u4", 2)
        assert uncomp == 500 * 7 * 4 and 0 < comp
        loaded = pcd.load_pcd(tmp_path / "z.pcd")
        np.testing.assert_array_equal(loaded.points, pc.points)
        np.testing.assert_allclose(loaded.colors, pc.colors, atol=1.0 / 255)
        np.testing.assert_array_equal(loaded.normals, pc.normals)

    def test_binary_compressed_fixture_parses(self, tmp_path):
        # A hand-built LZF stream: one literal run of 24 bytes (ctrl 23).
        soa = np.array([1.0, 4.0, 2.0, 5.0, 3.0, 6.0], "<f4").tobytes()
        stream = bytes([23]) + soa
        header = (
            "VERSION .7\nFIELDS x y z\nSIZE 4 4 4\nTYPE F F F\nCOUNT 1 1 1\n"
            "WIDTH 2\nHEIGHT 1\nVIEWPOINT 0 0 0 1 0 0 0\nPOINTS 2\n"
            "DATA binary_compressed\n"
        ).encode()
        sizes = np.array([len(stream), len(soa)], "<u4").tobytes()
        (tmp_path / "z.pcd").write_bytes(header + sizes + stream)
        loaded = pcd.load_pcd(tmp_path / "z.pcd")
        np.testing.assert_allclose(loaded.points, [[1, 2, 3], [4, 5, 6]])

    def test_binary_compressed_corrupt_raises(self, tmp_path):
        header = (
            "VERSION .7\nFIELDS x y z\nSIZE 4 4 4\nTYPE F F F\nCOUNT 1 1 1\n"
            "WIDTH 2\nHEIGHT 1\nVIEWPOINT 0 0 0 1 0 0 0\nPOINTS 2\n"
            "DATA binary_compressed\n"
        ).encode()
        stream = bytes([0b00100000, 0xFF, 0x00])  # a back-reference before the start
        sizes = np.array([len(stream), 24], "<u4").tobytes()
        (tmp_path / "z.pcd").write_bytes(header + sizes + stream)
        with pytest.raises(pcd.PcdFormatError, match="binary_compressed|LZF"):
            pcd.load_pcd(tmp_path / "z.pcd")

    @pytest.mark.parametrize("route", ["native", "python"])
    def test_compressed_bytes_match_reference(self, tmp_path, monkeypatch, route):
        from housescan_tpu.io import native as j_native
        from housescan_tpu_torch.io import native

        if route == "python":
            monkeypatch.setattr(native, "_load", lambda: None)
            monkeypatch.setattr(j_native, "_load", lambda: None)
        else:
            assert native.available() and j_native.available()
        rng = np.random.default_rng(3)
        pts = rng.normal(size=(300, 3)).astype(np.float32)
        pts[100:200] = pts[:100]  # repeats for the LZF back-references
        cloud = pcd.PointCloud(points=pts, colors=rng.uniform(size=(300, 3)).astype(np.float32))
        pcd.save_pcd(tmp_path / "port.pcd", cloud, compressed=True)
        j_pcd.save_pcd(tmp_path / "ref.pcd", j_pcd.PointCloud(cloud.points, cloud.colors),
                       compressed=True)
        assert (tmp_path / "port.pcd").read_bytes() == (tmp_path / "ref.pcd").read_bytes()
        back = pcd.load_pcd(tmp_path / "ref.pcd")
        np.testing.assert_array_equal(back.points, pts)


class TestNative:
    """The port's native helpers against the reference's, on both routes
    (exact: the same library source and the same numpy fallbacks)."""

    @pytest.fixture(params=["native", "python"])
    def natives(self, request, monkeypatch):
        from housescan_tpu.io import native as j_native
        from housescan_tpu_torch.io import native

        if request.param == "python":
            monkeypatch.setattr(native, "_load", lambda: None)
            monkeypatch.setattr(j_native, "_load", lambda: None)
        else:
            assert native.available() and j_native.available()
        return native, j_native

    def test_decode_u16_depth(self, natives):
        native, j_native = natives
        raw = np.random.default_rng(0).integers(0, 65535, size=(3, 48, 64)).astype(np.uint16)
        got = native.decode_u16_depth(raw, 0.001)
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, j_native.decode_u16_depth(raw, 0.001))

    def test_parse_ascii_floats(self, natives):
        native, j_native = natives
        text = b"1.5 -2 3e-3\n4 5.25 6\n"
        np.testing.assert_array_equal(native.parse_ascii_floats(text, 6),
                                      j_native.parse_ascii_floats(text, 6))
        with pytest.raises(ValueError, match="expected 7 floats"):
            native.parse_ascii_floats(text, 7)

    def test_transform_points(self, natives):
        native, j_native = natives
        rng = np.random.default_rng(1)
        pts = rng.normal(size=(257, 3)).astype(np.float32)
        m = np.eye(4, dtype=np.float32)
        m[:3, :3] = np.linalg.qr(rng.normal(size=(3, 3)))[0]
        m[3, :3] = rng.normal(size=3)
        np.testing.assert_array_equal(native.transform_points(pts, m),
                                      j_native.transform_points(pts, m))

    def test_lzf_round_trip(self, natives):
        native, j_native = natives
        data = bytes(np.random.default_rng(2).integers(0, 4, size=5000).astype(np.uint8))
        blob = native.lzf_compress(data)
        assert blob == j_native.lzf_compress(data) and len(blob) < len(data)
        assert native.lzf_decompress(blob, len(data)) == data
        with pytest.raises(ValueError):
            native.lzf_decompress(blob, len(data) + 1)

    def test_library_builds_outside_native_dir(self):
        from housescan_tpu_torch.io import native

        assert native.available()
        path = native._build()
        assert path.parent == native.BUILD_DIR and path.parent.name == "housescan_native"
