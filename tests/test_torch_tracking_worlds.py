"""Tracking twins of ``tests/test_kinfu.py`` beyond the noiseless box
world, on the port alone with the reference's bounds:

- the curved world (spheres, a capped cylinder, yaw-rotated boxes) on the
  kernel path, 128^3 packed, 160x120: < 25 mm after 6 frames, no frame
  lost (``test_tracking_closed_loop_curved_world``);
- Kinect-like depth noise (sigma 2 mm at 2 m) and the uint16-mm wire
  quantization on the XLA path (the reference's default there), 128^3
  float32: < 8 mm after 20 frames, no frame dropped
  (``test_tracking_under_sensor_noise_and_wire_quantization``);
- a tripod pause on the XLA path at 64^3: one frame fed 100 times walks
  the pose less than 0.2 voxel, and the last 60 repeats walk less than
  0.7 of the first 40 (``TestStationaryCamera``).
"""

import numpy as np
import pytest
import torch

from housescan_tpu_torch.kinfu.camera import Intrinsics
from housescan_tpu_torch.kinfu.pipeline import kinfu_init, kinfu_step
from housescan_tpu_torch.kinfu.synthetic import (
    curved_furnished_room,
    furnished_room,
    orbit_poses,
    render_depth_stream,
)
from housescan_tpu_torch.ops import cuda_lib

INTR = Intrinsics(width=160, height=120, fx=131.25, fy=131.25, cx=79.5, cy=59.5)


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _err(state, pose):
    return float(np.linalg.norm(state.pose[3, :3].numpy() - pose[3, :3]))


def test_tracking_closed_loop_curved_world():
    half, boxes, spheres, cyls, obbs = curved_furnished_room()
    poses = orbit_poses(10, radius=0.25, yaw_range=np.pi / 16, pitch=0.25)
    frames = render_depth_stream(INTR, poses, half, boxes, spheres=spheres, cylinders=cyls,
                                 obbs=obbs, device="cpu")
    st = kinfu_init(INTR, resolution=128, size_m=3.0, trunc=0.06, init_pose=poses[0],
                    dtype=torch.int32, device="cpu")
    cuda_lib.reset_counts()
    for i in range(7):
        st = kinfu_step(st, frames[i], INTR, use_pallas=True)
        assert bool(st.last_tracked), f"lost tracking at frame {i}"
    # the kernel path ran: each kernel wrapper took its plain version here
    assert all(cuda_lib.plain_counts[k] > 0 for k in cuda_lib.KERNEL_PATH)
    err = _err(st, poses[6])
    assert err < 0.025, f"curved-world drift {err * 1000:.1f}mm over 6 frames"


def test_tracking_under_sensor_noise_and_wire_quantization():
    half, boxes = furnished_room()
    n = 20
    poses = orbit_poses(n + 1, radius=0.25, yaw_range=0.02 * n, pitch=0.25)
    frames = render_depth_stream(INTR, poses, half, boxes, noise=0.002, seed=3, device="cpu")
    frames = torch.round(frames * 1000.0).to(torch.int32).to(torch.float32) / 1000.0
    assert float(frames.max()) < 65.535  # inside uint16 millimetres
    st = kinfu_init(INTR, resolution=128, size_m=3.2, trunc=0.06, init_pose=poses[0], device="cpu")
    drops = 0
    for k in range(n):
        st = kinfu_step(st, frames[k], INTR, use_pallas=False)
        drops += int(not bool(st.last_tracked))
    err = _err(st, poses[n - 1])
    assert err < 8e-3, f"noisy+quantized tracking err {err * 1000:.2f} mm"
    assert drops == 0


class TestStationaryCamera:
    def test_tripod_pause_creep_bounded_and_saturating(self):
        half, boxes = furnished_room()
        poses = orbit_poses(7, radius=0.25, yaw_range=0.12, pitch=0.25)
        frames = render_depth_stream(INTR, poses, half, boxes, device="cpu")
        st = kinfu_init(INTR, resolution=64, size_m=3.0, trunc=0.12, init_pose=poses[0],
                        device="cpu")
        for i in range(7):
            st = kinfu_step(st, frames[i], INTR, use_pallas=False)
        e_start = _err(st, poses[6])
        walks = []
        for k in range(100):
            st = kinfu_step(st, frames[6], INTR, use_pallas=False)
            if k in (39, 99):
                walks.append(_err(st, poses[6]))
        voxel = 3.0 / 64
        assert walks[-1] < 0.2 * voxel, f"stationary creep {walks[-1] * 1000:.2f} mm after 100 repeats"
        first40 = walks[0] - e_start
        last60 = walks[1] - walks[0]
        assert last60 < max(0.7 * first40, 0.2e-3), (
            f"creep not saturating: first 40 walked {first40 * 1000:.2f} mm,"
            f" last 60 walked {last60 * 1000:.2f} mm"
        )
