"""The port's live capture: twins of tests/test_live_capture.py (the
OpenNI-style device layer, latest-wins pacing, the ``scan --live`` CLI
against the recorded-device fixture, with ``--device cpu``) and of
test_capture_scan.py's fail-soft snapshot. The port imports no JAX, so
this file needs none."""

import time

import numpy as np
import pytest

from housescan_tpu_torch.capture.live import (
    FakeDevice,
    LiveSource,
    LiveStream,
    open_live_source,
)
from housescan_tpu_torch.capture.replay import record_stream, take_depth_snapshot
from housescan_tpu_torch.kinfu.camera import Intrinsics
from housescan_tpu_torch.kinfu.synthetic import furnished_room, orbit_poses, render_depth_stream

INTR = Intrinsics(width=160, height=120, fx=131.25, fy=131.25, cx=79.5, cy=59.5)


@pytest.fixture(scope="module")
def device_fixture(tmp_path_factory):
    half, boxes = furnished_room()
    poses = orbit_poses(6, radius=0.25, yaw_range=0.1, pitch=0.25)
    frames = render_depth_stream(INTR, poses, half, boxes=boxes, device="cpu").numpy()
    path = tmp_path_factory.mktemp("dev") / "device.npz"
    record_stream(path, frames, INTR, poses=poses)
    return path, frames


class TestFakeDevice:
    def test_wire_format_and_lifecycle(self, device_fixture):
        path, frames = device_fixture
        dev = FakeDevice.open(path)
        assert dev.intrinsics == INTR
        with pytest.raises(AssertionError):
            dev.read_frame()  # must start() first
        dev.start()
        got = []
        while (item := dev.read_frame()) is not None:
            frame_mm, ts = item
            assert frame_mm.dtype == np.uint16
            got.append((frame_mm, ts))
        assert len(got) == len(frames)
        # wire mm -> meters round trip within uint16 quantization
        np.testing.assert_allclose(
            got[0][0] * dev.depth_scale, frames[0], atol=6e-4
        )
        # timestamps advance at the device rate
        assert got[1][1] > got[0][1]
        dev.stop()

    def test_live_source_reads_all_when_consumer_keeps_up(self, device_fixture):
        path, frames = device_fixture
        src = LiveSource(FakeDevice.open(path, realtime=True, fps=200.0))
        n = 0
        while (f := src.read()) is not None:
            assert f.dtype == np.float32
            n += 1
        # paced device + prompt consumer: most frames seen, few drops
        assert n + src.dropped == len(frames)
        assert n >= 2

    def test_latest_wins_when_consumer_is_slow(self, device_fixture):
        path, frames = device_fixture
        # Device free-runs (no pacing): a slow consumer must see the
        # NEWEST frame and the overwritten ones must be counted.
        src = LiveSource(FakeDevice.open(path))
        time.sleep(0.3)  # let the pump race ahead
        first = src.read()
        assert first is not None
        rest = 0
        while src.read() is not None:
            rest += 1
        assert src.dropped > 0
        assert src.frames_read + src.dropped == len(frames)

    def test_live_stream_bounds_frames(self, device_fixture):
        path, _ = device_fixture
        src = LiveSource(
            FakeDevice.open(path, realtime=True, fps=500.0)
        )
        stream = LiveStream(src, max_frames=3)
        assert len(stream) == 3
        frames = list(stream)
        assert len(frames) <= 3


class TestOpenLiveSource:
    def test_fixture_env_selects_fake_device(self, device_fixture, monkeypatch):
        path, _ = device_fixture
        monkeypatch.setenv("HOUSESCAN_FAKE_DEVICE", str(path))
        src = open_live_source()
        assert src is not None
        assert src.intrinsics == INTR
        assert src.read() is not None
        src.stop()

    def test_fails_soft_without_device(self, monkeypatch, capsys):
        monkeypatch.delenv("HOUSESCAN_FAKE_DEVICE", raising=False)
        assert open_live_source() is None
        assert "no depth camera" in capsys.readouterr().err

    def test_snapshot_fails_soft(self, monkeypatch):
        # like the reference with no camera (tests/test_capture_scan.py)
        monkeypatch.delenv("HOUSESCAN_FAKE_DEVICE", raising=False)
        assert take_depth_snapshot() is None

    def test_snapshot_reads_the_fixture(self, device_fixture, monkeypatch):
        path, frames = device_fixture
        monkeypatch.setenv("HOUSESCAN_FAKE_DEVICE", str(path))
        frame = take_depth_snapshot()
        assert frame.dtype == np.float32 and frame.shape == frames[0].shape
        # latest-wins: one of the recorded frames, within uint16 mm quantization
        assert min(np.abs(frame - f).max() for f in frames) < 6e-4


class TestScanLiveCli:
    def test_scan_live_smoke(self, device_fixture, tmp_path, monkeypatch, capsys):
        path, _ = device_fixture
        monkeypatch.setenv("HOUSESCAN_FAKE_DEVICE", str(path))
        from housescan_tpu_torch.cli.main import main

        main(
            [
                "--scene", str(tmp_path / "scene.housescan"), "--device", "cpu",
                "scan", "--live", "--max-frames", "4",
                "--resolution", "128", "--size-m", "3.2",
                str(tmp_path / "live_room"),
            ]
        )
        out = tmp_path / "live_room"
        assert (out / "cloud_downsampled.pcd").exists()
        assert (out / "planes.txt").exists()
        traj = np.load(out / "trajectory.npz")["poses"]
        assert 1 <= len(traj) <= 4
        # every frame read was fused (one trajectory row a frame)
        read = int(capsys.readouterr().out.split("live scan: fused ")[1].split()[0])
        assert read == len(traj)


class TestOpenNIBinding:
    """The real-camera binding exercised through a faked ``openni``
    module in sys.modules (no camera in this image): bind must succeed
    and frames must flow through LiveSource; DeviceNotFound only when
    the import fails or no device answers (ref HoniHelper.hs:20-42)."""

    def _install_fake_openni(self, monkeypatch, frames_mm, w, h, fps=30.0,
                             open_raises=None):
        import sys
        import types

        class _Mode:
            resolutionX = w
            resolutionY = h

            def __init__(self):
                self.fps = fps

        class _Frame:
            def __init__(self, arr, i):
                self._arr = arr
                self.timestamp = int(i * 1e6 / fps)

            def get_buffer_as_uint16(self):
                return self._arr.tobytes()

        class _Stream:
            def __init__(self):
                self._i = 0
                self.started = False
                self.stopped = False

            def get_video_mode(self):
                return _Mode()

            def start(self):
                self.started = True

            def read_frame(self):
                if self._i >= len(frames_mm):
                    raise RuntimeError("stream ended")
                f = _Frame(frames_mm[self._i], self._i)
                self._i += 1
                return f

            def stop(self):
                self.stopped = True

        class _Device:
            last_stream = None

            @classmethod
            def open_any(cls):
                if open_raises is not None:
                    raise open_raises
                return cls()

            def create_depth_stream(self):
                _Device.last_stream = _Stream()
                return _Device.last_stream

        openni2 = types.SimpleNamespace(
            initialize=lambda: None, Device=_Device
        )
        pkg = types.ModuleType("openni")
        pkg.openni2 = openni2
        monkeypatch.setitem(sys.modules, "openni", pkg)
        monkeypatch.setitem(
            sys.modules, "openni.openni2", types.ModuleType("openni.openni2")
        )
        return _Device

    def test_bind_and_stream_through_live_source(self, monkeypatch):
        from housescan_tpu_torch.capture.live import OpenNIDevice

        rng = np.random.default_rng(0)
        frames_mm = (rng.uniform(400, 3000, size=(4, 120, 160))).astype(np.uint16)
        dev_cls = self._install_fake_openni(monkeypatch, frames_mm, 160, 120)

        dev = OpenNIDevice.open()
        # video mode wins: intrinsics scale from the 640-wide calibration
        assert (dev.intrinsics.width, dev.intrinsics.height) == (160, 120)
        assert dev.intrinsics.fx == pytest.approx(525.0 * 160 / 640)
        assert dev.fps == 30.0

        src = LiveSource(dev)
        got = 0
        while (f := src.read()) is not None:
            assert f.dtype == np.float32
            got += 1
        # latest-wins may drop intermediate frames but must deliver >=1
        # and end cleanly when the stream dies.
        assert 1 <= got <= len(frames_mm)
        assert got + src.dropped == len(frames_mm)
        src.stop()
        assert dev_cls.last_stream.stopped

    def test_wire_mm_to_meters(self, monkeypatch):
        from housescan_tpu_torch.capture.live import OpenNIDevice

        frames_mm = np.full((1, 120, 160), 1500, np.uint16)
        self._install_fake_openni(monkeypatch, frames_mm, 160, 120)
        dev = OpenNIDevice.open()
        dev.start()
        frame, ts = dev.read_frame()
        assert frame.dtype == np.uint16 and frame.shape == (120, 160)
        assert ts == pytest.approx(0.0)  # timestamp-0 first frame is real
        assert float(frame[0, 0]) * dev.depth_scale == pytest.approx(1.5)
        # The fake stream raises on the second read: the device layer
        # must turn that into a clean end-of-stream None.
        assert dev.read_frame() is None

    def test_no_device_answers(self, monkeypatch):
        from housescan_tpu_torch.capture.live import DeviceNotFound, OpenNIDevice

        self._install_fake_openni(
            monkeypatch, np.zeros((0, 1, 1), np.uint16), 160, 120,
            open_raises=RuntimeError("no devices"),
        )
        with pytest.raises(DeviceNotFound, match="no depth device binds"):
            OpenNIDevice.open()

    def test_import_failure(self):
        # no fake installed: the real import fails in this image
        from housescan_tpu_torch.capture.live import DeviceNotFound, OpenNIDevice

        with pytest.raises(DeviceNotFound, match="no OpenNI2 runtime"):
            OpenNIDevice.open()
