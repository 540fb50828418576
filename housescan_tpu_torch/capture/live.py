"""Live depth-camera capture: the device layer and a paced live frame
source (a copy of ``housescan_tpu/capture/live.py``).

  * ``OpenNIDevice`` binds a real camera when an OpenNI2 Python stack is
    importable; without one it raises ``DeviceNotFound``.
  * ``FakeDevice`` serves a recorded stream file (``capture.replay.
    record_stream``) as a device: uint16 mm frames at the recorded rate.
    ``HOUSESCAN_FAKE_DEVICE`` names such a file for ``open_live_source``.
  * ``LiveSource`` drains a device on a background thread into a
    depth-1 latest-frame slot: a slow consumer reads the newest frame and
    ``dropped`` counts the overwritten ones. ``read()`` decodes to
    float32 meters on the host (``io.native.decode_u16_depth``); the scan
    moves each frame to its device.
  * ``LiveStream`` gives a ``LiveSource`` the ``DepthStream`` shape the
    scan consumes, bounded by ``max_frames``.

With no camera and no fixture, ``open_live_source`` warns and returns
None, as the reference does: a missing camera is the user's input, not
a device the port runs on.
"""

from __future__ import annotations

import os
import sys
import threading
import time
from typing import Optional, Tuple

import numpy as np

from housescan_tpu_torch.config import CameraConfig
from housescan_tpu_torch.io import native
from housescan_tpu_torch.kinfu.camera import Intrinsics

DEFAULT_DEPTH_SCALE = 0.001  # uint16 wire unit -> meters (Kinect mm)


class DeviceNotFound(RuntimeError):
    pass


class OpenNIDevice:
    """Real-camera binding over the OpenNI2 Python stack.

    The reference's capture path (ref HoniHelper.hs:20-42): initialize
    -> open the first device -> create a depth stream -> start ->
    streamReadFrame yielding a Word16 buffer plus (width, height) from
    the stream's video mode. This class is that loop behind the
    DepthDevice interface: ``open()`` binds (raising DeviceNotFound if
    no OpenNI2 runtime imports or no camera answers — fail-soft like
    ref Main.hs:1288-1289), then ``start()`` / ``read_frame()`` /
    ``stop()`` serve uint16-mm wire frames.

    Intrinsics: focal lengths scale from the config's calibration by
    the stream's actual width (the reference hard-coded an ad-hoc scale
    and TODO'd real intrinsics, ref Main.hs:1307-1313; Kinect-class
    cameras share the 525 px @ 640 wide calibration)."""

    def __init__(self, openni2_mod, stream, intrinsics: Intrinsics,
                 fps: float, depth_scale: float = DEFAULT_DEPTH_SCALE):
        self._openni2 = openni2_mod
        self._stream = stream
        self.intrinsics = intrinsics
        self.fps = fps
        self.depth_scale = depth_scale
        self._started = False
        self._t0 = None

    @classmethod
    def open(cls, config: Optional[CameraConfig] = None) -> "OpenNIDevice":
        try:
            from openni import openni2  # type: ignore
        except ImportError as e:
            raise DeviceNotFound(
                "no OpenNI2 runtime importable (and no camera attached)"
            ) from e
        try:
            openni2.initialize()
            dev = openni2.Device.open_any()
            stream = dev.create_depth_stream()
            mode = stream.get_video_mode()
        except Exception as e:  # no camera, or OpenNI refuses it: fail soft
            raise DeviceNotFound(
                f"OpenNI2 importable but no depth device binds: {e}"
            ) from e
        w = int(mode.resolutionX)
        h = int(mode.resolutionY)
        fps = float(mode.fps) if getattr(mode, "fps", 0) else 30.0
        cfg = config or CameraConfig()
        # Scale each axis by ITS OWN ratio and scale the calibrated
        # principal point instead of recentering: non-4:3 video modes
        # and off-center calibrations keep correct intrinsics.
        sx = w / cfg.width
        sy = h / cfg.height
        intr = Intrinsics(
            width=w, height=h, fx=cfg.fx * sx, fy=cfg.fy * sy,
            cx=cfg.cx * sx, cy=cfg.cy * sy,
        )
        return cls(openni2, stream, intr, fps, cfg.depth_scale)

    def start(self):
        self._stream.start()
        self._t0 = time.monotonic()
        self._started = True

    def read_frame(self) -> Optional[Tuple[np.ndarray, float]]:
        """(uint16 mm frame, device timestamp seconds) or None when the
        stream dies (unplugged camera ends the source, not the scan)."""
        assert self._started, "start() the device first"
        try:
            frame = self._stream.read_frame()
            buf = frame.get_buffer_as_uint16()
        except Exception:
            return None
        arr = np.frombuffer(buf, dtype=np.uint16).reshape(
            self.intrinsics.height, self.intrinsics.width
        ).copy()  # OpenNI recycles its frame buffer; detach before queueing
        # OpenNI timestamps are microseconds from stream start. The
        # first frame legitimately stamps 0 — only a MISSING attribute
        # falls back to the wall clock, not a falsy value.
        ts_us = getattr(frame, "timestamp", None)
        ts = ts_us / 1e6 if ts_us is not None else time.monotonic() - self._t0
        return arr, ts

    def stop(self):
        self._started = False
        try:
            self._stream.stop()
        except Exception:
            pass


class FakeDevice:
    """A recorded stream served with device semantics (uint16 mm wire
    frames, fixed frame rate, start/stop lifecycle)."""

    def __init__(
        self,
        depth_mm: np.ndarray,
        intrinsics: Intrinsics,
        fps: float = 30.0,
        depth_scale: float = DEFAULT_DEPTH_SCALE,
        realtime: bool = False,
    ):
        assert depth_mm.dtype == np.uint16, depth_mm.dtype
        self.depth_mm = depth_mm
        self.intrinsics = intrinsics
        self.fps = fps
        self.depth_scale = depth_scale
        self.realtime = realtime
        self._i = 0
        self._started = False
        self._t0 = None

    @classmethod
    def open(cls, path, fps: float = 30.0, realtime: bool = False) -> "FakeDevice":
        data = np.load(path)
        ia = data["intrinsics"]
        intr = Intrinsics(
            width=int(ia[0]), height=int(ia[1]),
            fx=float(ia[2]), fy=float(ia[3]),
            cx=float(ia[4]), cy=float(ia[5]),
        )
        scale = float(data["depth_scale"]) if "depth_scale" in data.files else DEFAULT_DEPTH_SCALE
        return cls(
            data["depth_mm"], intr, fps=fps, depth_scale=scale,
            realtime=realtime,
        )

    def start(self):
        self._started = True
        self._t0 = time.monotonic()

    def read_frame(self) -> Optional[Tuple[np.ndarray, float]]:
        """(uint16 mm frame, device timestamp seconds) or None at end."""
        assert self._started, "start() the device first"
        if self._i >= len(self.depth_mm):
            return None
        if self.realtime:
            target = self._t0 + self._i / self.fps
            delay = target - time.monotonic()
            if delay > 0:
                time.sleep(delay)
        frame = self.depth_mm[self._i]
        ts = self._i / self.fps
        self._i += 1
        return frame, ts

    def stop(self):
        self._started = False


class LiveSource:
    """Paced live frame source over a DepthDevice.

    ``read()`` returns the NEWEST available frame in meters (float32),
    or None once the device ends. Frames the consumer never saw are
    counted in ``dropped`` — a live camera cannot be back-pressured,
    so a slow fusion loop skips ahead rather than falling behind
    (latest-wins, like the reference's snapshot IORef)."""

    def __init__(self, device, drop_old: bool = True):
        self.device = device
        self.drop_old = drop_old
        self.dropped = 0
        self.frames_read = 0
        self._cond = threading.Condition()
        self._latest = None  # (frame_mm, ts) not yet consumed
        self._ended = False
        device.start()
        self._thread = threading.Thread(target=self._pump, daemon=True)
        self._thread.start()

    @property
    def intrinsics(self) -> Intrinsics:
        return self.device.intrinsics

    def _pump(self):
        while True:
            item = self.device.read_frame()
            with self._cond:
                if item is None:
                    self._ended = True
                    self._cond.notify_all()
                    return
                if self._latest is not None and self.drop_old:
                    self.dropped += 1
                elif self._latest is not None:
                    # back-pressured mode: wait for the consumer
                    while self._latest is not None and not self._ended:
                        self._cond.wait()
                self._latest = item
                self._cond.notify_all()

    def read(self) -> Optional[np.ndarray]:
        """Newest frame in METERS, or None at device end."""
        with self._cond:
            while self._latest is None and not self._ended:
                self._cond.wait()
            if self._latest is None:
                return None
            frame_mm, _ts = self._latest
            self._latest = None
            self._cond.notify_all()
        self.frames_read += 1
        return native.decode_u16_depth(
            frame_mm[None], self.device.depth_scale
        )[0]

    def stop(self):
        self.device.stop()


def open_live_source(
    config: Optional[CameraConfig] = None,
    realtime: bool = False,
) -> Optional[LiveSource]:
    """Best live source available: a real OpenNI camera if one binds,
    else the HOUSESCAN_FAKE_DEVICE recorded-device fixture, else None
    with a warning (fail-soft, ref Main.hs:1288-1289)."""
    try:
        return LiveSource(OpenNIDevice.open(config))
    except DeviceNotFound as e:
        # Say WHY the real camera didn't bind (an attached-but-
        # misconfigured camera should not silently become a fake device).
        print(f"live capture: {e}", file=sys.stderr)
    fake = os.environ.get("HOUSESCAN_FAKE_DEVICE")
    if fake and os.path.exists(fake):
        return LiveSource(FakeDevice.open(fake, realtime=realtime))
    print(
        "WARNING: no depth camera (and no HOUSESCAN_FAKE_DEVICE fixture); "
        "use recorded streams",
        file=sys.stderr,
    )
    return None


class LiveStream:
    """DepthStream-shaped view over a LiveSource so scan_to_room_dir
    consumes a live camera unchanged (bounded by ``max_frames`` — the
    CLI's scan duration; a camera has no natural end)."""

    def __init__(self, source: LiveSource, max_frames: int = 300):
        self.source = source
        self.max_frames = max_frames

    @property
    def intrinsics(self) -> Intrinsics:
        return self.source.intrinsics

    def __len__(self) -> int:
        return self.max_frames

    def __iter__(self):
        for _ in range(self.max_frames):
            frame = self.source.read()
            if frame is None:
                return
            yield frame
