"""Parity of the port's ICP level (K3) and 6x6 solve with the reference.

The same packed (19, H, W) level input goes through the reference's
``icp_level_pallas`` (interpret mode) and the port's ``icp_level``; the
bounds are the reference's own for its fused kernel against its XLA loop
(``tests/test_tsdf_stream.py``): pose atol 5e-5, rmse within 1e-4,
correspondence count within max(5, n/200). The solve math is held to
the reference's 2e-5.
"""

import pytest

pytest.importorskip("jax")

import jax.numpy as jnp
import numpy as np
import torch

from housescan_tpu.kinfu.camera import Intrinsics as JIntrinsics
from housescan_tpu.kinfu.icp import _model_gradients
from housescan_tpu.kinfu.preprocess import depth_to_vertices, vertex_normals
from housescan_tpu.kinfu.synthetic import furnished_room, orbit_poses, render_depth_stream
from housescan_tpu.ops.icp_pallas import icp_level_pallas, pack_level_maps
from housescan_tpu.ops.solve6_pallas import _solve_twist_math as j_solve
from housescan_tpu_torch.kinfu.camera import Intrinsics
from housescan_tpu_torch.ops.icp_cuda import H100_SMEM_OPTIN, N_ROWS, icp_level, icp_plan
from housescan_tpu_torch.ops.solve6 import solve_twist_math

JINTR = JIntrinsics(width=160, height=120, fx=131.25, fy=131.25, cx=79.5, cy=59.5)
INTR = Intrinsics(*JINTR)


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _level_input(intr=JINTR, yaw=0.03):
    """Packed level maps: frame 0 as the model, frame 1 as the live view."""
    half, boxes = furnished_room()
    poses = orbit_poses(2, radius=0.25, yaw_range=yaw, pitch=0.25)
    frames = render_depth_stream(intr, poses, half, boxes=boxes)
    p0 = jnp.asarray(poses[0])
    v0 = depth_to_vertices(jnp.asarray(frames[0]), intr)
    n0 = vertex_normals(v0)
    mv = v0 @ p0[:3, :3] + p0[3, :3]
    mn = n0 @ p0[:3, :3]
    mok = (v0[..., 2] > 0) & (jnp.linalg.norm(n0, axis=-1) > 0.5)
    v1 = depth_to_vertices(jnp.asarray(frames[1]), intr)
    n1 = vertex_normals(v1)
    packed = pack_level_maps(v1, n1, mv, mn, mok, _model_gradients(mv, mok))
    return np.array(packed), np.array(poses[0])


@pytest.mark.parametrize(
    "yaw,n_iters,window,dist,tight",
    [(0.03, 6, 4, 0.10, None), (0.01, 10, 0, 0.10, 0.0117), (0.02, 5, 2, 0.05, 0.006)],
)
def test_level_matches_pallas(yaw, n_iters, window, dist, tight):
    """Inter-frame motion inside each level's association window."""
    packed, p0 = _level_input(yaw=yaw)
    j_pose, j_rmse, j_corr = icp_level_pallas(
        jnp.asarray(packed), jnp.asarray(p0), jnp.asarray(p0), JINTR,
        n_iters=n_iters, window=window, dist_threshold=dist,
        tight_threshold=tight, interpret=True,
    )
    t_pose, t_rmse, t_corr = icp_level(
        torch.from_numpy(packed), torch.from_numpy(p0), torch.from_numpy(p0), INTR,
        n_iters=n_iters, window=window, dist_threshold=dist, tight_threshold=tight,
    )
    np.testing.assert_allclose(t_pose.numpy(), np.asarray(j_pose), atol=5e-5)
    assert abs(float(t_rmse) - float(j_rmse)) < 1e-4
    assert int(j_corr) > 1000
    assert abs(int(t_corr) - int(j_corr)) <= max(5, int(j_corr) // 200)


def test_level_tight_gate_widens_on_collapse():
    """A tight gate far below the true residuals collapses the
    correspondence count; the adaptive gate must widen and still track
    (same behaviour as the reference kernel)."""
    packed, p0 = _level_input(yaw=0.04)
    args = dict(n_iters=10, window=4, dist_threshold=0.10, tight_threshold=1e-4)
    j_pose, _, j_corr = icp_level_pallas(
        jnp.asarray(packed), jnp.asarray(p0), jnp.asarray(p0), JINTR, interpret=True, **args
    )
    t_pose, _, t_corr = icp_level(
        torch.from_numpy(packed), torch.from_numpy(p0), torch.from_numpy(p0), INTR, **args
    )
    np.testing.assert_allclose(t_pose.numpy(), np.asarray(j_pose), atol=5e-5)
    assert int(j_corr) > 1000
    assert abs(int(t_corr) - int(j_corr)) <= max(5, int(j_corr) // 200)


def test_solve_matches_reference():
    rng = np.random.default_rng(3)
    for _ in range(10):
        g = rng.normal(size=(50, 6))
        a = (g.T @ g).astype(np.float32)
        b = (rng.normal(size=6) * 0.1).astype(np.float32)
        pose = np.eye(4, dtype=np.float32)
        pose[3, :3] = rng.normal(size=3)
        want = j_solve([jnp.float32(x) for x in a.reshape(-1)], [jnp.float32(x) for x in b],
                       [jnp.float32(x) for x in pose.reshape(-1)], jnp.float32(3e-4), jnp.float32(0.3))
        got = solve_twist_math(list(torch.from_numpy(a.reshape(-1))), list(torch.from_numpy(b)),
                               list(torch.from_numpy(pose.reshape(-1))),
                               torch.tensor(3e-4), torch.tensor(0.3))
        np.testing.assert_allclose(np.array([float(x) for x in got]),
                                   np.array([float(x) for x in want]), atol=2e-5)


@pytest.mark.parametrize("case", ["zero_a", "nan_a", "nan_b"])
def test_degenerate_system_keeps_pose(case):
    pose = np.eye(4, dtype=np.float32)
    pose[3, :3] = [0.3, -0.1, 1.7]
    a = {"zero_a": np.zeros((6, 6)), "nan_a": np.full((6, 6), np.nan), "nan_b": np.eye(6)}[case]
    b = np.full(6, np.nan) if case == "nan_b" else np.ones(6)
    out = solve_twist_math(list(torch.tensor(a, dtype=torch.float32).reshape(-1)),
                           list(torch.tensor(b, dtype=torch.float32)),
                           list(torch.from_numpy(pose.reshape(-1))),
                           torch.tensor(3e-4), torch.tensor(0.3))
    np.testing.assert_array_equal(np.array([float(x) for x in out[:16]]).reshape(4, 4), pose)
    assert float(out[16]) <= 1e-9


def test_rejects_unpadded_input():
    with pytest.raises(ValueError):
        icp_level(torch.zeros(19, 120, 160), torch.eye(4), torch.eye(4), INTR, n_iters=1)


@pytest.mark.parametrize("shape", [(3, 4), (16,), (4, 4, 1)])
def test_rejects_prev_pose_of_wrong_shape(shape):
    """The kernel reads the previous pose as a row-major (4, 4): any other
    shape is refused, on the CPU as on the card."""
    with pytest.raises(ValueError):
        icp_level(torch.zeros(19, 128, 256), torch.eye(4), torch.zeros(shape), INTR, n_iters=1)


# The (hp, wp) of the packed maps at the three levels of 640x480 (rows to
# 32, columns to 128), and the SM counts of the H100's SXM and PCIe parts.
VGA_LEVELS = [(480, 640), (256, 384), (128, 256)]


@pytest.mark.parametrize("n_sms", [132, 114], ids=["sxm", "pcie"])
@pytest.mark.parametrize("hp,wp", VGA_LEVELS, ids=["level0", "level1", "level2"])
def test_plan_slices_fit(hp, wp, n_sms):
    """One contiguous slice a block, at most one block an SM, every pixel
    in exactly one slice, and each slice's 19 rows in shared memory."""
    plan = icp_plan(hp, wp, n_sms)
    n = hp * wp
    assert plan.blocks <= n_sms
    assert plan.pixels_per_block % 32 == 0
    assert (plan.blocks - 1) * plan.pixels_per_block < n <= plan.blocks * plan.pixels_per_block
    assert plan.shared_pixels == plan.pixels_per_block
    assert plan.pixels_per_block * N_ROWS * 4 < plan.smem_bytes <= H100_SMEM_OPTIN


@pytest.mark.parametrize("hp,wp,n_sms", [
    (736, 1280, 132),  # 1280x720 (rows to 32) on an H100 SXM: 545 KB a slice
    (960, 1280, 132),  # 1280x960: 708 KB a slice
    (480, 640, 16),  # 640x480 on 16 SMs: 1.46 MB a slice
], ids=["hd720", "sxga", "vga-16sms"])
def test_plan_holds_what_fits_of_a_large_slice(hp, wp, n_sms):
    """A slice larger than a block's shared memory keeps its first pixels
    there, as many as fit (a multiple of 32), and the rest in global
    memory; the grid is unchanged."""
    plan = icp_plan(hp, wp, n_sms)
    n = hp * wp
    assert plan.blocks <= n_sms
    assert (plan.blocks - 1) * plan.pixels_per_block < n <= plan.blocks * plan.pixels_per_block
    assert plan.shared_pixels % 32 == 0
    assert plan.shared_pixels < plan.pixels_per_block
    assert plan.smem_bytes <= H100_SMEM_OPTIN < plan.smem_bytes + 32 * N_ROWS * 4


@pytest.mark.parametrize("hp,wp,n_sms,max_smem", [
    (960, 1280, 132, 4096),  # no room beside the kernel's own shared memory
    (480, 640, 16, 4096 + 32 * N_ROWS * 4 - 1),  # one byte short of a warp's pixels
    (480, 640, 132, 1024),
])
def test_plan_that_cannot_fit_raises(hp, wp, n_sms, max_smem):
    with pytest.raises(ValueError):
        icp_plan(hp, wp, n_sms, max_smem)
