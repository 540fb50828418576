"""Recorded depth streams: record, load, replay, prefetch.

A copy of ``housescan_tpu/capture/replay.py``. A stream is a .npz of
uint16 millimeter frames (the Kinect wire format) plus intrinsics and,
when known, the ground-truth poses; frames load to host float32 meters
(``raw.astype(np.float32) * scale``) and go to the device one at a time in
the scan loop. The live device is ``capture/live.py``.
"""

from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from pathlib import Path
from typing import Iterator, Optional, Union

import numpy as np
import torch

from housescan_tpu_torch.config import CameraConfig
from housescan_tpu_torch.kinfu.camera import Intrinsics
from housescan_tpu_torch.kinfu.preprocess import depth_to_vertices


@dataclass
class DepthStream:
    """A recorded depth stream: (N, H, W) float32 meters + intrinsics."""

    frames: np.ndarray
    intrinsics: Intrinsics
    poses: Optional[np.ndarray] = None  # (N, 4, 4) ground truth if known

    def __len__(self) -> int:
        return len(self.frames)

    def __iter__(self) -> Iterator[np.ndarray]:
        return iter(self.frames)


def record_stream(
    path: Union[str, Path],
    frames: np.ndarray,
    intrinsics: Intrinsics,
    poses: Optional[np.ndarray] = None,
    depth_scale: float = 0.001,
) -> Path:
    """Write a stream as uint16 millimeters. ``frames`` may be a numpy
    array or a tensor on any device."""
    path = Path(path)
    if isinstance(frames, torch.Tensor):
        frames = frames.detach().cpu().numpy()
    raw = np.clip(np.round(np.asarray(frames) / depth_scale), 0, 65535).astype(np.uint16)
    payload = {
        "depth_mm": raw,
        "intrinsics": np.array(
            [intrinsics.width, intrinsics.height, intrinsics.fx, intrinsics.fy,
             intrinsics.cx, intrinsics.cy],
            np.float64,
        ),
        "depth_scale": np.float64(depth_scale),
    }
    if poses is not None:
        payload["poses"] = np.asarray(poses, np.float32)
    np.savez_compressed(path, **payload)
    return path


def load_stream(path: Union[str, Path]) -> DepthStream:
    with np.load(Path(path)) as data:
        ia = data["intrinsics"]
        intr = Intrinsics(
            width=int(ia[0]), height=int(ia[1]),
            fx=float(ia[2]), fy=float(ia[3]), cx=float(ia[4]), cy=float(ia[5]),
        )
        scale = float(data["depth_scale"]) if "depth_scale" in data.files else 0.001
        frames = np.ascontiguousarray(data["depth_mm"], np.uint16).astype(np.float32) * scale
        poses = data["poses"] if "poses" in data.files else None
    return DepthStream(frames=frames, intrinsics=intr, poses=poses)


class ReplaySource:
    """Frame-at-a-time source over a recorded stream."""

    def __init__(self, stream: DepthStream):
        self.stream = stream
        self._i = 0

    @classmethod
    def open(cls, path: Union[str, Path]) -> "ReplaySource":
        return cls(load_stream(path))

    @property
    def intrinsics(self) -> Intrinsics:
        return self.stream.intrinsics

    def read(self) -> Optional[np.ndarray]:
        """Next depth frame in meters, or None at the end of the stream."""
        if self._i >= len(self.stream):
            return None
        frame = self.stream.frames[self._i]
        self._i += 1
        return frame


class PrefetchingSource:
    """Reads frames from ``source`` on a worker thread into a bounded
    queue, so loading overlaps the device's work on the previous frame.
    Drain it to None, or call ``close``."""

    def __init__(self, source, depth: int = 4):
        self._source = source
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._done = object()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    @property
    def intrinsics(self):
        return self._source.intrinsics

    def _run(self):
        while not self._stop.is_set():
            frame = self._source.read()
            item = self._done if frame is None else frame
            while not self._stop.is_set():
                try:
                    self._q.put(item, timeout=0.1)
                    break
                except queue.Full:
                    continue
            if frame is None:
                return

    def read(self):
        item = self._q.get()
        return None if item is self._done else item

    def close(self, timeout: float = 5.0) -> None:
        """Stop the worker and wait for it."""
        self._stop.set()
        self._thread.join(timeout)


def take_depth_snapshot(config: Optional[CameraConfig] = None) -> Optional[np.ndarray]:
    """One depth frame in meters from the best live device
    (``capture/live.py``: a real OpenNI camera, or the
    ``HOUSESCAN_FAKE_DEVICE`` recorded-device fixture); None, with a
    warning, when no device binds."""
    from housescan_tpu_torch.capture.live import open_live_source

    src = open_live_source(config)
    if src is None:
        return None
    frame = src.read()
    src.stop()
    return frame


def depth_frame_to_cloud(depth: np.ndarray, intr: Intrinsics) -> np.ndarray:
    """Backproject one depth frame to camera-frame points, dropping
    invalid pixels."""
    verts = depth_to_vertices(torch.from_numpy(np.asarray(depth, np.float32)), intr).numpy()
    return verts[np.asarray(depth) > 0]
