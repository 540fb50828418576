"""The port's synthetic worlds against the reference's: the curved world
(spheres, a capped cylinder, yaw-rotated boxes), sensor noise with its
seed, the pose generators and the ground-truth TSDF.

Bounds: depth within 1e-5 m, with at most 0.1% of pixels over it (rays
that graze an edge may meet the other surface under a different rounding)
and the hit masks (depth > 0) identical; noisy frames of the same seed
within 1e-5 m (the noise is drawn by the same numpy generator and added
in float64, so only the depth's own rounding differs); pose generators,
rooms and the 64^3 ground-truth TSDF exact.
"""

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

from housescan_tpu.kinfu import synthetic as J
from housescan_tpu.kinfu.camera import Intrinsics as JIntrinsics
from housescan_tpu_torch.kinfu import synthetic as T
from housescan_tpu_torch.kinfu.camera import Intrinsics

INTR = Intrinsics(width=160, height=120, fx=131.25, fy=131.25, cx=79.5, cy=59.5)
JINTR = JIntrinsics(*INTR)


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _poses():
    """Orbit poses toward every face, pitched both ways, with look jitter."""
    return np.concatenate([
        T.orbit_poses(6, radius=0.25, yaw_range=2 * np.pi, pitch=0.25),
        T.orbit_poses(4, radius=0.5, height=0.3, yaw_range=2 * np.pi, pitch=-0.4,
                      look_jitter=0.05, seed=2),
    ])


def _close_depth(port, ref, atol=1e-5, max_share=1e-3):
    assert port.shape == ref.shape and port.dtype == np.float32
    np.testing.assert_array_equal(port > 0, ref > 0)
    far = np.abs(port - ref) > atol
    assert far.mean() <= max_share, f"{far.sum()} pixels differ by more than {atol} m"


@pytest.mark.parametrize("world", ["curved", "box"])
def test_depth_matches_reference(world):
    if world == "curved":
        half, boxes, spheres, cyls, obbs = T.curved_furnished_room()
        shapes = dict(boxes=boxes, spheres=spheres, cylinders=cyls, obbs=obbs)
    else:
        half, boxes = T.furnished_room()
        shapes = dict(boxes=boxes)
    poses = _poses()
    port = T.render_depth_stream(INTR, poses, half, device="cpu", **shapes)
    assert port.device.type == "cpu"
    ref = np.asarray(J.render_depth_stream(JINTR, poses, half, **shapes))
    _close_depth(port.numpy(), ref)
    if world == "curved":
        # the curved shapes are in view: the frames differ from the box world's
        box = T.render_depth_stream(INTR, poses, half, boxes=boxes, device="cpu").numpy()
        assert (np.abs(box - port.numpy()) > 0.05).mean() > 0.05


def test_noisy_frames_match_reference_with_the_same_seed():
    half, boxes = T.furnished_room()
    poses = _poses()[:4]
    port = T.render_depth_stream(INTR, poses, half, boxes, noise=0.002, seed=3, device="cpu").numpy()
    ref = np.asarray(J.render_depth_stream(JINTR, poses, half, boxes=boxes, noise=0.002, seed=3))
    np.testing.assert_allclose(port, ref, atol=1e-5, rtol=0)
    clean = T.render_depth_stream(INTR, poses, half, boxes, device="cpu").numpy()
    assert np.abs(port - clean).max() > 1e-4  # the noise is there
    other = T.render_depth_stream(INTR, poses, half, boxes, noise=0.002, seed=4, device="cpu").numpy()
    assert not np.allclose(other, port, atol=1e-5)


def test_pose_generators_and_rooms_exact():
    np.testing.assert_array_equal(_poses(), np.concatenate([
        J.orbit_poses(6, radius=0.25, yaw_range=2 * np.pi, pitch=0.25),
        J.orbit_poses(4, radius=0.5, height=0.3, yaw_range=2 * np.pi, pitch=-0.4,
                      look_jitter=0.05, seed=2),
    ]))
    np.testing.assert_array_equal(
        T.orbit_poses(8, radius=0.7, height=-0.6, yaw_range=6.283, pitch=-1.2, seed=1),
        J.orbit_poses(8, radius=0.7, height=-0.6, yaw_range=6.283, pitch=-1.2, seed=1))
    np.testing.assert_array_equal(T.spiral_poses(50, height_max=0.3),
                                  J.spiral_poses(50, height_max=0.3))
    np.testing.assert_array_equal(T.spiral_poses(17, turns=1.0, pitch_max=0.5),
                                  J.spiral_poses(17, turns=1.0, pitch_max=0.5))
    cov = T.coverage_sweep_poses()
    assert cov.shape == (542, 4, 4)  # 67 + 204 + 67 + 204 poses
    np.testing.assert_array_equal(cov, J.coverage_sweep_poses())
    np.testing.assert_array_equal(T.coverage_sweep_poses(0.3), J.coverage_sweep_poses(0.3))
    for a, b in zip(T.curved_furnished_room(0.9), J.curved_furnished_room(0.9)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(T.flat_furnished_room(), J.flat_furnished_room()):
        np.testing.assert_array_equal(a, b)


def test_ground_truth_tsdf_exact():
    half, _ = T.furnished_room()
    origin = np.array([-1.5, -1.5, -1.5], np.float32)
    port = T.ground_truth_tsdf(64, 3.0, origin, half, 0.06, device="cpu")
    ref = J.ground_truth_tsdf(64, 3.0, origin, half, 0.06)
    assert port.dtype == torch.float32 and tuple(port.shape) == (64, 64, 64)
    np.testing.assert_array_equal(port.numpy(), ref)


def test_center_pixel_sees_the_curved_furniture():
    """The twin of the reference's center-pixel check, on a sphere: a
    camera looking +z along a line through the large ball's center
    (0.35, -0.5, 0.95; r 0.30) sees its near side 0.65 m away."""
    half, boxes, spheres, cyls, obbs = T.curved_furnished_room()
    pose = np.eye(4, dtype=np.float32)
    pose[3, :3] = [0.35, -0.5, 0.0]
    d = T.render_depth_stream(INTR, pose[None], half, boxes, spheres=spheres, cylinders=cyls,
                              obbs=obbs, device="cpu")[0]
    assert float(d[60, 80]) == pytest.approx(0.95 - 0.30, abs=1e-3)
