"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``gpu``: each test asks for the ``cuda`` fixture, which skips
where no CUDA device is present. Run them on the card with

    python -m pytest -m gpu tests/test_torch_*.py

Inputs come from the port's own synthetic module (no JAX). The library
builds with --fmad=false, so kernel and plain version run the same
float32 operations; they differ only in summation order. Bounds: K1
bit-identical (each pixel sums its taps in the plain version's order), at
odd sizes and every radius too; K3 pose 5e-5, rmse 1e-4, correspondences max(5, n/200) (the
reference's bounds for its fused level), and two runs of K3 on the same
inputs bit-identical (no float atomics); K4 weights identical, the tsdf
within one quantization step (packed) or 1e-6 (float32) on >= 99.9% of
voxels, plane valid flags on >= 99.9% of sub-blocks, fields 1e-5 (both
sum the moments in float64), field 11 identical; K6 valid masks on >=
99.5% of pixels, rows 1e-5 where both hit, and bit-identical on all 9
rows with a tile emptied and one filled to every slot (the nearest hit
and occluder do not depend on the candidates' order); K5 bit-identical
(the carve has no reduction whose order could differ), also on an empty
and a thinned list, and so the split and unsplit integrates too, on
both layouts; K2 bit-identical (the same scalar operations in the same
order), also on degenerate, non-finite and non-contiguous inputs, a step
above ``max_step`` and theta = 0, and on degenerate systems the pose
exactly unchanged; K7 and K8 bit-identical, K7 also on an empty volume,
a fully observed one and one with a single observed sub-block, at a
non-cubic size, K8's chunk
classes too (the fit sums in float64 and rounds once; K8's bilinear
repeats its plain version's operation order), K8 at R = 128, 256 and 512,
on SKIP and FREE columns and with a surface on a chunk boundary.
"""

import numpy as np
import pytest
import torch

from housescan_tpu_torch.kinfu import maps as mp
from housescan_tpu_torch.kinfu.camera import Intrinsics
from housescan_tpu_torch.kinfu.pipeline import kinfu_init, kinfu_run, kinfu_step
from housescan_tpu_torch.kinfu.preprocess import bilateral_filter, build_pyramid
from housescan_tpu_torch.kinfu.synthetic import furnished_room, orbit_poses, render_depth_stream
from housescan_tpu_torch.kinfu.tsdf import pack_tw, tsdf_new
from housescan_tpu_torch.ops import cuda_lib
from housescan_tpu_torch.ops.chunk_select import build_worklist
from housescan_tpu_torch.kinfu.icp import DAMPINGS
from housescan_tpu_torch.ops.icp_cuda import (
    BAND_H,
    _plan,
    icp_level,
    icp_level_plain,
    icp_level_state,
)
from housescan_tpu_torch.ops.preprocess_cuda import bilateral_filter_cuda, bilateral_filter_plain
from housescan_tpu_torch.ops.solve6 import solve_twist_compose, solve_twist_plain
from housescan_tpu_torch.ops.raycast_tiles import (
    _ray_params,
    build_tile_candidates,
    launch_raycast_kernel,
    raycast_tiles_plain,
)
from housescan_tpu_torch.ops.chunk_select import decode_free_worklist
from housescan_tpu_torch.ops.planes_cuda import (
    _extract_params,
    extract_planes_plain,
    launch_extract_kernel,
)
from housescan_tpu_torch.ops.raycast_planes import raycast_pallas
from housescan_tpu_torch.ops.tsdf_cuda import (
    CLS_FREE,
    CLS_SKIP,
    dense_inputs,
    dense_integrate_plain,
    launch_dense_kernel,
    tsdf_integrate_with_planes,
)
from housescan_tpu_torch.ops.tsdf_stream import (
    FIELD_SAT,
    N_QUARTERS,
    _stream_params,
    build_depth_mips,
    free_carve_plain,
    integrate_plain,
    launch_free_kernel,
    launch_stream_kernel,
    planes_shape,
    stream_grid,
    tsdf_integrate_stream,
)

VGA = Intrinsics(640, 480, 525.0, 525.0, 319.5, 239.5)
QQVGA = Intrinsics(160, 120, 131.25, 131.25, 79.5, 59.5)
HD720 = Intrinsics(1280, 720, 1050.0, 1050.0, 639.5, 359.5)


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: python -m pytest -m gpu tests/test_torch_*.py on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _stream(intr, n, yaw, device):
    half, boxes = furnished_room()
    poses = orbit_poses(n, radius=0.25, yaw_range=yaw, pitch=0.25)
    return poses, render_depth_stream(intr, poses, half, boxes, device=device)


@pytest.mark.gpu
def test_bilateral_kernel_matches_plain(cuda):
    _, frames = _stream(VGA, 1, 0.0, cuda)
    d = frames[0].clone()
    d[100:140, 200:260] = 0.0
    got = bilateral_filter_cuda(d)
    want = bilateral_filter(d)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert bool((got[100:140, 200:260] == 0).all())


def _bilateral_frame(device, h, w):
    """An (h, w) crop of a VGA room frame with a hole and a hard edge (no
    tile of the kernel divides 161 x 121 or 7 x 5)."""
    _, frames = _stream(VGA, 1, 0.0, device)
    d = frames[0][:h, :w].clone()
    d[h // 3 : h // 3 + max(1, h // 8), w // 4 : w // 4 + max(1, w // 6)] = 0.0
    d[: max(1, h // 5)] *= 2.0
    return d


@pytest.mark.gpu
@pytest.mark.parametrize("radius", [0, 1, 3, 7])
@pytest.mark.parametrize("hw", [(480, 640), (120, 160), (121, 161), (5, 7)],
                         ids=["640x480", "160x120", "161x121", "7x5"])
def test_bilateral_kernel_bit_identical_at_sizes_and_radii(cuda, hw, radius):
    """K1 against its plain version bit for bit, at tile-aligned and odd
    sizes and at radius 0, 1, 3 (the default) and 7 (the largest)."""
    d = _bilateral_frame(cuda, *hw)
    before = cuda_lib.launch_counts["bilateral"]
    got = bilateral_filter_cuda(d, radius)
    want = bilateral_filter_plain(d, radius)
    torch.cuda.synchronize()
    assert cuda_lib.launch_counts["bilateral"] == before + 1
    assert torch.equal(got, want)
    assert bool((got[d == 0] == 0).all())


@pytest.mark.gpu
@pytest.mark.parametrize("frame", ["all_invalid", "one_valid"])
def test_bilateral_kernel_bit_identical_on_sparse_frames(cuda, frame):
    """An all-invalid frame filters to zeros; one valid pixel keeps its depth."""
    d = torch.zeros(480, 640, device=cuda)
    if frame == "one_valid":
        d[200, 300] = 1.75
    for radius in (0, 3, 7):
        got = bilateral_filter_cuda(d, radius)
        want = bilateral_filter_plain(d, radius)
        torch.cuda.synchronize()
        assert torch.equal(got, want)
        assert torch.equal(got, d)


@pytest.mark.gpu
@pytest.mark.parametrize("intr,yaw", [(VGA, 0.008), (HD720, 0.004)], ids=["vga", "hd720"])
def test_icp_kernel_matches_plain(cuda, intr, yaw):
    """A frame pair (2 px of motion, window 4): frame 0 as the model. At
    640x480 every block holds its slice in shared memory; at 1280x720 a
    slice is larger than that, and each block reads the rest of its pixels
    from global memory every iteration."""
    poses, frames = _stream(intr, 2, yaw, cuda)
    p0 = torch.from_numpy(poses[0]).to(cuda)
    live0 = build_pyramid(frames[0], intr).maps[0]
    rot, t = p0[:3, :3], p0[3, :3]
    v_w = torch.einsum("chw,cd->dhw", live0[0:3], rot) + t[:, None, None]
    n_w = torch.einsum("chw,cd->dhw", live0[3:6], rot)
    valid = ((live0[3:6] ** 2).sum(0) > 0.25).to(torch.float32)
    model = torch.cat([frames[0][None], v_w, n_w, valid[None]]) * valid
    live1 = build_pyramid(frames[1], intr).maps[0]
    packed = mp.pack_icp_inputs(live1, model, mp.model_gradients(model), band_h=BAND_H)
    plan = _plan(packed.shape[1], packed.shape[2], packed.device.index)
    assert (plan.shared_pixels < plan.pixels_per_block) == (intr is HD720)
    args = dict(n_iters=10, window=4, dist_threshold=0.10, tight_threshold=0.0117)
    before = cuda_lib.launch_counts["icp_level"]
    kp, kr, kc = icp_level(packed, p0, p0, intr, **args)
    qp, qr, qc = icp_level_plain(packed, p0, p0, intr, **args)
    torch.cuda.synchronize()
    assert cuda_lib.launch_counts["icp_level"] == before + 1
    assert int(qc) > 10000
    assert float((kp - qp).abs().max()) <= 5e-5
    assert abs(float(kr) - float(qr)) < 1e-4
    assert abs(int(kc) - int(qc)) <= max(5, int(qc) // 200)


def _icp_level_input(cuda, level, yaw=0.008):
    """Packed maps of one pyramid level of a 640x480 frame pair (frame 0's
    maps in world space as the model, frame 1 live), frame 0's pose and
    the level's intrinsics."""
    poses, frames = _stream(VGA, 2, yaw, cuda)
    p0 = torch.from_numpy(poses[0]).to(cuda)
    live0 = build_pyramid(frames[0], VGA).maps[level]
    rot, t = p0[:3, :3], p0[3, :3]
    v_w = torch.einsum("chw,cd->dhw", live0[0:3], rot) + t[:, None, None]
    n_w = torch.einsum("chw,cd->dhw", live0[3:6], rot)
    valid = ((live0[3:6] ** 2).sum(0) > 0.25).to(torch.float32)
    model = torch.cat([live0[2:3], v_w, n_w, valid[None]]) * valid
    live1 = build_pyramid(frames[1], VGA).maps[level]
    packed = mp.pack_icp_inputs(live1, model, mp.model_gradients(model), band_h=BAND_H)
    return packed, p0, VGA.level(level)


def _icp_matches_plain(packed, p0, cam, min_corr, start=None, **args):
    start = p0 if start is None else start
    kp, kr, kc = icp_level(packed, start, p0, cam, **args)
    qp, qr, qc = icp_level_plain(packed, start, p0, cam, **args)
    torch.cuda.synchronize()
    assert int(qc) > min_corr
    assert float((kp - qp).abs().max()) <= 5e-5
    assert abs(float(kr) - float(qr)) < 1e-4
    assert abs(int(kc) - int(qc)) <= max(5, int(qc) // 200)


@pytest.mark.gpu
@pytest.mark.parametrize("level", [0, 1, 2])
def test_icp_kernel_matches_plain_at_each_level(cuda, level):
    """The step's iterations, windows and dampings a level (one launch a
    level), with the adaptive gate."""
    packed, p0, cam = _icp_level_input(cuda, level)
    args = dict(n_iters=(10, 5, 4)[level], window=(4, 2, 4)[level],
                dist_threshold=(0.0117, 0.05, 0.10)[level], damping=DAMPINGS[level],
                tight_threshold=0.0117)
    before = cuda_lib.launch_counts["icp_level"]
    _icp_matches_plain(packed, p0, cam, packed.shape[1] * packed.shape[2] // 40, **args)
    assert cuda_lib.launch_counts["icp_level"] == before + 1


@pytest.mark.gpu
def test_icp_kernel_widens_like_plain(cuda):
    """A start pose 3 cm off collapses the correspondences under the tight
    gate: the kernel widens (widen_until > 0), recovers and matches."""
    packed, p0, cam = _icp_level_input(cuda, 0)
    start = p0.clone()
    start[3, 2] += 0.03
    args = dict(n_iters=10, window=4, dist_threshold=0.10, tight_threshold=0.0117)
    state = icp_level_state(packed, start, p0, cam, **args)
    assert float(state[21]) > 0
    _icp_matches_plain(packed, p0, cam, 10000, start=start, **args)


@pytest.mark.gpu
def test_icp_kernel_converges_early_like_plain(cuda):
    """Thirty iterations at level 2 on a small motion: every block leaves
    the loop at the same iteration, before the last, and the result
    matches the plain version's masked loop."""
    packed, p0, cam = _icp_level_input(cuda, 2, yaw=0.004)
    args = dict(n_iters=30, window=4, dist_threshold=0.10, damping=DAMPINGS[2],
                tight_threshold=0.0117)
    state = icp_level_state(packed, p0, p0, cam, **args)
    assert float(state[19]) == 1.0 and float(state[18]) < 30
    _icp_matches_plain(packed, p0, cam, 1000, **args)


@pytest.mark.gpu
def test_icp_kernel_repeats_bit_for_bit(cuda):
    packed, p0, cam = _icp_level_input(cuda, 0)
    args = dict(n_iters=10, window=4, dist_threshold=0.0117, tight_threshold=0.0117)
    a = icp_level_state(packed, p0, p0, cam, **args)
    b = icp_level_state(packed, p0, p0, cam, **args)
    torch.cuda.synchronize()
    assert torch.equal(a, b)


LAYOUTS = [torch.int32, torch.float32]


def _weights(data):
    return (data & 0xFFFF).to(torch.float32) if data.dim() == 3 else data[1]


def _tsdf_steps(data):
    """The tsdf in quantization steps (packed) or as stored (float32)."""
    return data >> 16 if data.dim() == 3 else data[0]


@pytest.fixture(params=LAYOUTS, ids=["packed", "float32"])
def fused(cuda, request):
    """A 128^3 volume of each layout with one fused frame, and the next
    frame's inputs."""
    poses, frames = _stream(QQVGA, 2, 0.3, cuda)
    vol = tsdf_new(128, 3.0, 0.06, dtype=request.param, device=cuda)
    planes = torch.zeros(planes_shape(128), device=cuda)
    pose0 = torch.from_numpy(poses[0]).to(cuda)
    vol, planes = tsdf_integrate_stream(vol, planes, frames[0], pose0, QQVGA)
    return vol, planes, frames[1], torch.from_numpy(poses[1]).to(cuda)


@pytest.mark.gpu
def test_stream_kernel_matches_plain(fused):
    vol, planes, d, p = fused
    sat = planes[:, :, :, FIELD_SAT, :4].reshape(-1, 4) > 0.5
    wl = build_worklist(d, p, QQVGA, 128, vol.voxel_size, vol.origin, vol.trunc, sat_quarters=sat)
    mips = build_depth_mips(d)
    params = _stream_params(vol, p, QQVGA, 128.0, 16, 1)
    kd, kp = vol.data.clone(), planes.clone()
    launch_stream_kernel(kd, kp, wl.desc, wl.count, mips, params)
    qd, qp = vol.data.clone(), planes.clone()
    integrate_plain(qd, qp, wl.desc, wl.count, mips, params, 16, 1)
    torch.cuda.synchronize()
    assert torch.equal(_weights(kd), _weights(qd))
    assert int(_weights(kd).max()) == 2
    step = 1 if kd.dim() == 3 else 1e-6
    assert float(((_tsdf_steps(kd) - _tsdf_steps(qd)).abs() <= step).float().mean()) >= 0.999
    kv, qv = kp[:, :, :, 4] > 0.5, qp[:, :, :, 4] > 0.5
    assert int(qv.sum()) > 30
    assert float((kv == qv).float().mean()) >= 0.999
    both = (kv & qv)[:, :, :, None, :].expand_as(kp)
    assert float((kp - qp)[both].abs().max()) <= 1e-5
    assert torch.equal(kp[:, :, :, FIELD_SAT], qp[:, :, :, FIELD_SAT])


@pytest.fixture(params=LAYOUTS, ids=["packed", "float32"])
def fused_vga(cuda, request):
    """A 256^3 volume of each layout with one fused 640x480 frame, and the
    next frame's work list, mips and parameters: a list longer than K4's
    persistent grid."""
    poses, frames = _stream(VGA, 2, 0.3, cuda)
    vol = tsdf_new(256, 3.0, 0.03, dtype=request.param, device=cuda)
    planes = torch.zeros(planes_shape(256), device=cuda)
    tsdf_integrate_stream(vol, planes, frames[0], torch.from_numpy(poses[0]).to(cuda), VGA)
    p1 = torch.from_numpy(poses[1]).to(cuda)
    sat = planes[:, :, :, FIELD_SAT, :4].reshape(-1, 4) > 0.5
    wl = build_worklist(frames[1], p1, VGA, 256, vol.voxel_size, vol.origin, vol.trunc,
                        sat_quarters=sat)
    return vol, planes, wl, build_depth_mips(frames[1]), _stream_params(vol, p1, VGA, 128.0, 32, 2)


@pytest.mark.gpu
@pytest.mark.parametrize("count", ["none", "one", "all"])
def test_stream_kernel_persistent_grid_matches_plain(fused_vga, count):
    """K4 on lists of 0, 1 and more chunks than its grid has blocks."""
    vol, planes, wl, mips, params = fused_vga
    layout = "packed" if vol.data.dim() == 3 else "float32"
    grid = stream_grid(wl.desc.shape[0], cuda_lib.occupancy("tsdf_stream")[layout],
                       cuda_lib.device_limits()[0])
    n = {"none": 0, "one": 1, "all": int(wl.count[0])}[count]
    if count == "all":
        assert n > grid
    cnt = torch.tensor([n], dtype=torch.int32, device=vol.data.device)
    kd, kp = vol.data.clone(), planes.clone()
    launch_stream_kernel(kd, kp, wl.desc, cnt, mips, params)
    qd, qp = vol.data.clone(), planes.clone()
    integrate_plain(qd, qp, wl.desc, cnt, mips, params, 32, 2)
    torch.cuda.synchronize()
    assert torch.equal(_weights(kd), _weights(qd))
    if n == 0:
        assert torch.equal(kd, vol.data) and torch.equal(kp, planes)
        return
    if count == "all":
        assert int((_weights(qd) != _weights(vol.data)).sum()) > 100000
    step = 1 if kd.dim() == 3 else 1e-6
    assert float(((_tsdf_steps(kd) - _tsdf_steps(qd)).abs() <= step).float().mean()) >= 0.999
    kv, qv = kp[:, :, :, 4] > 0.5, qp[:, :, :, 4] > 0.5
    assert float((kv == qv).float().mean()) >= 0.999
    both = (kv & qv)[:, :, :, None, :].expand_as(kp)
    if bool(both.any()):
        assert float((kp - qp)[both].abs().max()) <= 1e-5
    assert torch.equal(kp[:, :, :, FIELD_SAT], qp[:, :, :, FIELD_SAT])


@pytest.mark.gpu
def test_raycast_kernel_matches_plain(fused):
    vol, planes, _, p = fused
    cand = build_tile_candidates(planes, p, QQVGA, vol)
    params = _ray_params(p, QQVGA, 0.3, 2)
    k = launch_raycast_kernel(cand, params, 120, 256)
    q = raycast_tiles_plain(cand, params, 120, 256)
    torch.cuda.synchronize()
    kv, qv = k[0] > 0, q[0] > 0
    assert int(qv.sum()) > 5000
    assert float((kv == qv).float().mean()) >= 0.995
    assert float((k[:7] - q[:7])[:, kv & qv].abs().max()) <= 1e-5


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", LAYOUTS, ids=["packed", "float32"])
def test_step_runs_through_every_kernel(cuda, dtype):
    """Three fused frames on the card, on each layout: every kernel of the
    path launched, no other and no plain version, the poses match the CPU
    run of the same stream (same operations, other summation order) to
    1e-3, and one more step makes the host wait on the card nowhere
    (PyTorch's sync debug mode raises on a synchronisation)."""
    poses, frames = _stream(QQVGA, 4, np.pi / 64, cuda)
    cuda_lib.reset_counts()
    st = kinfu_init(QQVGA, resolution=128, size_m=3.0, trunc=0.06, init_pose=poses[0],
                    dtype=dtype, device=cuda)
    st, traj = kinfu_run(st, frames[:3], QQVGA)
    torch.cuda.synchronize()
    assert all(cuda_lib.launch_counts[k] > 0 for k in cuda_lib.KERNEL_PATH)
    assert all(cuda_lib.launch_counts[k] == 0 for k in cuda_lib.KERNELS
               if k not in cuda_lib.KERNEL_PATH)
    assert all(cuda_lib.plain_counts[k] == 0 for k in cuda_lib.KERNELS)
    torch.cuda.set_sync_debug_mode("error")
    try:
        st = kinfu_step(st, frames[3], QQVGA)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    cpu = kinfu_init(QQVGA, resolution=128, size_m=3.0, trunc=0.06, init_pose=poses[0],
                     dtype=dtype, device="cpu")
    cpu, traj_cpu = kinfu_run(cpu, frames[:3].cpu(), QQVGA)
    np.testing.assert_allclose(traj.cpu().numpy(), traj_cpu.numpy(), atol=1e-3)
    assert np.linalg.norm(st.pose[3, :3].cpu().numpy() - poses[3][3, :3]) < 0.02


def _carved_scene(cuda, n, dtype=torch.int32):
    """A 0.75 m cube of free space in front of the orbit's camera (5.9 mm
    voxels at 128^3), where the free carve's members hold voxels in view."""
    poses, frames = _stream(QQVGA, n, 0.3, cuda)
    vol = tsdf_new(128, 0.75, 0.06, origin=torch.tensor([-0.375, -0.375, 0.35]), dtype=dtype,
                   device=cuda)
    return vol, torch.zeros(planes_shape(128), device=cuda), poses, frames


def _carved_free_list(cuda, dtype):
    """The carved scene after frame 0 (unsplit), frame 1's free work list
    and parameters."""
    vol, planes, poses, frames = _carved_scene(cuda, 2, dtype)
    vol, planes = tsdf_integrate_stream(vol, planes, frames[0], torch.from_numpy(poses[0]).to(cuda),
                                        QQVGA, free_split=False)
    p1 = torch.from_numpy(poses[1]).to(cuda)
    sat = planes[:, :, :, FIELD_SAT, :N_QUARTERS].reshape(-1, N_QUARTERS) > 0.5
    neg = planes[:, :, :, FIELD_SAT, N_QUARTERS].reshape(-1) > 0.5
    _, fwl = build_worklist(frames[1], p1, QQVGA, 128, vol.voxel_size, vol.origin, vol.trunc,
                            sat_quarters=sat, neg_flags=neg, free_split=True)
    return vol, planes, fwl, _stream_params(vol, p1, QQVGA, 128.0, 16, 1)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", LAYOUTS, ids=["packed", "float32"])
def test_free_kernel_matches_plain(cuda, dtype):
    vol, planes, fwl, params = _carved_free_list(cuda, dtype)
    assert len(decode_free_worklist(fwl)[1]) > 16
    before = cuda_lib.launch_counts["tsdf_free"]
    kd, kp = vol.data.clone(), planes.clone()
    launch_free_kernel(kd, kp, fwl, params)
    qd, qp = vol.data.clone(), planes.clone()
    free_carve_plain(qd, qp, fwl, params)
    torch.cuda.synchronize()
    assert cuda_lib.launch_counts["tsdf_free"] == before + 1
    assert int((kd != vol.data).sum()) > 10000
    assert torch.equal(kd, qd)
    assert torch.equal(kp, qp)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", LAYOUTS, ids=["packed", "float32"])
def test_free_kernel_on_an_empty_list_changes_nothing(cuda, dtype):
    """K5's persistent grid over a list whose count is 0: one launch, the
    volume and planes untouched."""
    vol, planes, fwl, params = _carved_free_list(cuda, dtype)
    empty = fwl._replace(count=torch.zeros_like(fwl.count))
    before = cuda_lib.launch_counts["tsdf_free"]
    kd, kp = vol.data.clone(), planes.clone()
    launch_free_kernel(kd, kp, empty, params)
    torch.cuda.synchronize()
    assert cuda_lib.launch_counts["tsdf_free"] == before + 1
    assert torch.equal(kd, vol.data)
    assert torch.equal(kp, planes)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", LAYOUTS, ids=["packed", "float32"])
def test_free_kernel_on_a_thinned_list_matches_plain(cuda, dtype):
    """K5 on the list with its last listed entry dropped from the count and
    every other member bit of the rest cleared (a count below the list's
    capacity, clear member bits inside it): bit-identical to the plain
    version, which carves only the members left."""
    vol, planes, fwl, params = _carved_free_list(cuda, dtype)
    n = int(fwl.count[0])
    assert 0 < n < fwl.bitmap.shape[0]
    count = max(n - 1, 1)
    thin = fwl._replace(count=torch.full_like(fwl.count, count),
                        bitmap=fwl.bitmap & 0x5555)
    members = len(decode_free_worklist(thin)[1])
    assert 0 < members < len(decode_free_worklist(fwl)[1])
    kd, kp = vol.data.clone(), planes.clone()
    launch_free_kernel(kd, kp, thin, params)
    qd, qp = vol.data.clone(), planes.clone()
    free_carve_plain(qd, qp, thin, params)
    torch.cuda.synchronize()
    assert int((qd != vol.data).sum()) > 1000
    assert torch.equal(kd, qd)
    assert torch.equal(kp, qp)


def _stress_candidates(cand, seed=0):
    """``cand`` with its busiest tile filled to every slot (jittered copies
    of its own candidates under new, unique block ids) and the next
    busiest emptied. Returns (candidates, full tile, empty tile)."""
    rng = np.random.default_rng(seed)
    cand = cand.clone()
    counts = (cand[:, :, 9] > 0.5).sum(dim=1)
    order = torch.argsort(counts, descending=True, stable=True)
    full, empty = int(order[0]), int(order[1])
    n, max_ct = int(counts[full]), cand.shape[1]
    assert n > 0
    extra = cand[full, torch.arange(max_ct - n, device=cand.device) % n].clone()
    jitter = torch.from_numpy(rng.uniform(0.995, 1.005, (max_ct - n, 4)).astype(np.float32))
    jitter = jitter.to(cand.device)
    extra[:, 3] *= jitter[:, 0]  # the plane moves along its normal
    extra[:, 4:7] *= jitter[:, 1:]  # and its support centre
    extra[:, 8] = 1.0e6 + torch.arange(max_ct - n, device=cand.device, dtype=torch.float32)
    cand[full, n:] = extra
    cand[empty] = 0.0
    return cand, full, empty


@pytest.mark.gpu
@pytest.mark.parametrize("size", ["vga", "qqvga"])
def test_raycast_kernel_bit_identical_with_empty_and_full_tiles(cuda, size):
    """K6 at 640x480 (96 candidates a tile) and at 160x120 (384), on the
    planes of two fused frames with one tile emptied and one filled to
    every slot: all 9 rows bit-identical to the plain version."""
    intr, res, trunc, max_ct = (VGA, 256, 0.03, 96) if size == "vga" else (QQVGA, 128, 0.06, 384)
    poses, frames = _stream(intr, 2, 0.3, cuda)
    vol = tsdf_new(res, 3.0, trunc, device=cuda)
    planes = torch.zeros(planes_shape(res), device=cuda)
    for d, p in zip(frames, poses):
        tsdf_integrate_stream(vol, planes, d, torch.from_numpy(p).to(cuda), intr)
    pose = torch.from_numpy(poses[1]).to(cuda)
    cand, full, empty = _stress_candidates(build_tile_candidates(planes, pose, intr, vol))
    counts = (cand[:, :, 9] > 0.5).sum(dim=1)
    assert cand.shape[1] == max_ct and int(counts[full]) == max_ct and int(counts[empty]) == 0
    n_ut = -(-intr.width // 128)
    params = _ray_params(pose, intr, 0.3, n_ut)
    k = launch_raycast_kernel(cand, params, intr.height, n_ut * 128)
    q = raycast_tiles_plain(cand, params, intr.height, n_ut * 128)
    torch.cuda.synchronize()
    assert torch.equal(k, q)

    def tile(g):
        b, ut = divmod(g, n_ut)
        return q[:, b * 8:(b + 1) * 8, ut * 128:(ut + 1) * 128]

    assert int((tile(full)[0] > 0).sum()) > 100
    assert int((q[0] > 0).sum()) > intr.width * intr.height // 4
    assert bool((tile(empty)[0] == 0).all()) and bool((tile(empty)[7] == -1).all())


def _random_candidates(rng, intr, pose, max_ct):
    """Seeded candidates for every tile of ``intr`` (0 to ``max_ct`` of them,
    the first tile empty and the last full): support centres in or near
    the tile's view at 0.05-4 m, some behind the camera or holding it,
    radii 5 mm-0.5 m, planes through the centre facing the camera or not,
    a fifth of them occluders, block ids unique in a tile."""
    n_ut = -(-intr.width // 128)
    n_tiles = intr.height // 8 * n_ut
    cand = np.zeros((n_tiles, max_ct, 16), np.float32)
    rot = pose[:3, :3]
    for g in range(n_tiles):
        n = 0 if g == 0 else max_ct if g == n_tiles - 1 else int(rng.integers(0, max_ct + 1))
        b, ut = divmod(g, n_ut)
        u = ut * 128 + rng.uniform(-30, 158, n)
        v = b * 8 + rng.uniform(-20, 28, n)
        z = rng.uniform(-0.5, 4.0, n)
        c = np.stack([(u - intr.cx) / intr.fx * z, (v - intr.cy) / intr.fy * z, z], axis=1)
        r = c @ rot  # camera to world, relative to the camera centre
        nrm = -c / np.linalg.norm(c, axis=1, keepdims=True) + rng.normal(0, 0.5, (n, 3))
        nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
        rad = 10.0 ** rng.uniform(-2.3, -0.3, n)
        cand[g, :n, 0:3] = nrm
        cand[g, :n, 3] = (nrm * r).sum(axis=1)
        cand[g, :n, 4:7] = r
        cand[g, :n, 7] = rad * rad
        cand[g, :n, 8] = rng.permutation(4096)[:n]
        cand[g, :n, 9] = 1.0
        cand[g, :n, 10] = rng.random(n) < 0.2
        cand[g, :n, 11] = rng.uniform(0, 0.05, n)
    return cand


@pytest.mark.gpu
@pytest.mark.parametrize("rotation", ["orthonormal", "skewed"])
@pytest.mark.parametrize("size", ["vga", "qqvga"])
def test_raycast_kernel_bit_identical_on_random_candidates(cuda, size, rotation):
    """K6 on seeded random candidates, its pixel-box cull included: all 9
    rows bit-identical to the plain version. A skewed rotation (rows
    scaled by 1.01: no cull) takes the kernel's uncut path."""
    rng = np.random.default_rng(6)
    intr, max_ct = (VGA, 96) if size == "vga" else (QQVGA, 384)
    q_, _ = np.linalg.qr(rng.normal(size=(3, 3)))
    pose = np.eye(4, dtype=np.float32)
    pose[:3, :3] = q_ * np.sign(np.linalg.det(q_))
    if rotation == "skewed":
        pose[:3, :3] *= 1.01
    pose[3, :3] = rng.normal(size=3)
    cand = torch.from_numpy(_random_candidates(rng, intr, pose.astype(np.float64), max_ct)).to(cuda)
    n_ut = -(-intr.width // 128)
    params = _ray_params(torch.from_numpy(pose).to(cuda), intr, 0.3, n_ut)
    k = launch_raycast_kernel(cand, params, intr.height, n_ut * 128)
    q = raycast_tiles_plain(cand, params, intr.height, n_ut * 128)
    torch.cuda.synchronize()
    assert int((q[0] > 0).sum()) > intr.width * intr.height // 10
    assert int((q[8] < 1.0e9).sum()) > intr.width * intr.height // 20
    assert torch.equal(k, q)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", LAYOUTS, ids=["packed", "float32"])
@pytest.mark.parametrize("scene", ["room", "carved"])
def test_split_orbit_bit_identical_to_unsplit(cuda, scene, dtype):
    """Three frames at the orbit's poses, with and without the split."""
    if scene == "carved":
        va, pa, poses, frames = _carved_scene(cuda, 3, dtype)
    else:
        poses, frames = _stream(QQVGA, 3, 0.3, cuda)
        va = tsdf_new(128, 3.0, 0.06, dtype=dtype, device=cuda)
        pa = torch.zeros(planes_shape(128), device=cuda)
    vb, pb = va._replace(data=va.data.clone()), pa.clone()
    for d, p in zip(frames, poses):
        p = torch.from_numpy(p).to(cuda)
        tsdf_integrate_stream(va, pa, d, p, QQVGA, free_split=True)
        tsdf_integrate_stream(vb, pb, d, p, QQVGA, free_split=False)
    torch.cuda.synchronize()
    assert torch.equal(va.data, vb.data)
    assert torch.equal(pa, pb)


@pytest.mark.gpu
def test_solve_kernel_matches_plain(cuda):
    """K2 on random SPD systems (the reference test's seed) and on the
    degenerate ones: bit-identical to its plain version on the card."""
    rng = np.random.default_rng(3)
    before = cuda_lib.launch_counts["solve6"]
    for _ in range(10):
        g = rng.normal(size=(50, 6))
        a = torch.tensor((g.T @ g).astype(np.float32), device=cuda)
        b = torch.tensor((rng.normal(size=6) * 0.1).astype(np.float32), device=cuda)
        pose = torch.eye(4, device=cuda)
        pose[3, :3] = torch.tensor(rng.normal(size=3).astype(np.float32), device=cuda)
        kp, kn = solve_twist_compose(pose, a, b, damping=3e-4)
        qp, qn = solve_twist_plain(pose, a, b, damping=3e-4)
        torch.cuda.synchronize()
        assert torch.equal(kp, qp)
        assert torch.equal(kn, qn)
    assert cuda_lib.launch_counts["solve6"] == before + 10
    pose = torch.eye(4, device=cuda)
    pose[3, :3] = torch.tensor([0.3, -0.1, 1.7], device=cuda)
    nan = float("nan")
    for a, b in ((torch.zeros(6, 6), torch.ones(6)), (torch.full((6, 6), nan), torch.ones(6)),
                 (torch.eye(6), torch.full((6,), nan))):
        kp, kn = solve_twist_compose(pose, a.to(cuda), b.to(cuda))
        qp, qn = solve_twist_plain(pose, a.to(cuda), b.to(cuda))
        torch.cuda.synchronize()
        assert torch.equal(kp, pose)
        assert float(kn) <= 1e-9
        assert torch.equal(kp, qp) and torch.equal(kn, qn)


def _k2_case(case, rng):
    """(pose, A, b) float32 numpy arrays of one edge case of the solve."""
    g = rng.normal(size=(50, 6))
    a = (g.T @ g).astype(np.float32)
    b = (rng.normal(size=6) * 0.1).astype(np.float32)
    pose = np.eye(4, dtype=np.float32)
    pose[:3, :3] = np.linalg.qr(rng.normal(size=(3, 3)))[0].astype(np.float32)
    pose[3, :3] = rng.normal(size=3)
    if case == "above_max_step":  # the step clamped to max_step, theta up to 0.3
        b = b * np.float32(200.0)
    elif case == "theta_zero":  # block-diagonal A, no rotation in b: x[:3] exactly 0
        a[:3, 3:] = 0.0
        a[3:, :3] = 0.0
        b[:3] = 0.0
    elif case == "inf_a":
        a[2, 4] = np.inf
    elif case == "inf_b":
        b[1] = -np.inf
    elif case == "indefinite":  # a negative pivot: the pose is kept
        a = -a
    return pose, a, b


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["above_max_step", "theta_zero", "inf_a", "inf_b", "indefinite"])
def test_solve_kernel_bit_identical_on_edge_systems(cuda, case):
    """K2 on 32 systems of each edge case: every pose entry and the step
    norm bit-identical to the plain version (the sine's and cosine's
    Taylor terms over theta up to max_step included)."""
    rng = np.random.default_rng(11)
    for _ in range(32):
        pose, a, b = (torch.from_numpy(x).to(cuda) for x in _k2_case(case, rng))
        kp, kn = solve_twist_compose(pose, a, b, damping=3e-4)
        qp, qn = solve_twist_plain(pose, a, b, damping=3e-4)
        torch.cuda.synchronize()
        assert torch.equal(kp, qp) and torch.equal(kn, qn)
        if case == "above_max_step":
            assert abs(float(kn) - 0.3) < 1e-6
        if case in ("inf_a", "inf_b", "indefinite"):
            assert torch.equal(kp, pose) and float(kn) == 0.0


@pytest.mark.gpu
def test_solve_kernel_reads_non_contiguous_inputs(cuda):
    """K2 on a transposed A, a strided b and a strided pose (each copied
    to contiguous float32 by the wrapper), and on float64 inputs: the same
    bits as the plain version on contiguous copies."""
    rng = np.random.default_rng(5)
    pose, a, b = (torch.from_numpy(x).to(cuda) for x in _k2_case("above_max_step", rng))
    a_t = a.t().contiguous().t()  # the same values, column-major
    b_s = torch.stack([b, torch.zeros_like(b)], dim=1)[:, 0]
    p_s = torch.stack([pose, torch.zeros_like(pose)], dim=2)[:, :, 0]
    assert not (a_t.is_contiguous() or b_s.is_contiguous() or p_s.is_contiguous())
    qp, qn = solve_twist_plain(pose, a, b)
    for args in ((p_s, a_t, b_s), (pose.double(), a.double(), b.double())):
        kp, kn = solve_twist_compose(*args)
        torch.cuda.synchronize()
        assert torch.equal(kp, qp) and torch.equal(kn, qn)


@pytest.mark.gpu
def test_plain_division_by_a_scalar_is_a_reciprocal_multiply(cuda):
    """The premise of K2's sine: on the card PyTorch divides a tensor by a
    Python scalar as a multiply by the scalar's float32 reciprocal, which
    the kernel repeats for the plain version's ``t2 / 362880``."""
    t2 = torch.rand(1 << 20, generator=torch.Generator(device=cuda).manual_seed(0),
                    device=cuda) * 0.09
    inv = torch.tensor(1.0) / torch.tensor(362880.0)
    assert torch.equal(t2 / 362880, t2 * inv.to(cuda))


@pytest.mark.gpu
def test_xla_step_on_card_matches_cpu(cuda):
    """Three frames of the XLA path (use_pallas=False) on a 128^3 float32
    volume on the card: K1 and K2 launched, no other kernel and no plain
    version, and the poses match the CPU run of the same stream to 1e-3
    (the step parity bound above; the reductions sum in another order)."""
    poses, frames = _stream(QQVGA, 4, np.pi / 64, cuda)
    cuda_lib.reset_counts()
    st = kinfu_init(QQVGA, resolution=128, size_m=3.0, trunc=0.06, init_pose=poses[0],
                    dtype=torch.float32, device=cuda)
    st, traj = kinfu_run(st, frames[:3], QQVGA, use_pallas=False)
    torch.cuda.synchronize()
    assert all(cuda_lib.launch_counts[k] > 0 for k in cuda_lib.XLA_PATH)
    assert all(cuda_lib.launch_counts[k] == 0 for k in cuda_lib.KERNELS if k not in cuda_lib.XLA_PATH)
    assert all(cuda_lib.plain_counts[k] == 0 for k in cuda_lib.KERNELS)
    cpu = kinfu_init(QQVGA, resolution=128, size_m=3.0, trunc=0.06, init_pose=poses[0],
                     dtype=torch.float32, device="cpu")
    cpu, traj_cpu = kinfu_run(cpu, frames[:3].cpu(), QQVGA, use_pallas=False)
    np.testing.assert_allclose(traj.cpu().numpy(), traj_cpu.numpy(), atol=1e-3)
    assert float(st.model_maps[7].mean()) > 0.5


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", LAYOUTS, ids=["packed", "float32"])
def test_extract_kernel_matches_plain(cuda, dtype):
    """K7 on a volume of each layout with two fused frames."""
    poses, frames = _stream(QQVGA, 2, 0.3, cuda)
    vol = tsdf_new(128, 3.0, 0.06, dtype=dtype, device=cuda)
    planes = torch.zeros(planes_shape(128), device=cuda)
    for d, p in zip(frames, poses):
        tsdf_integrate_stream(vol, planes, d, torch.from_numpy(p).to(cuda), QQVGA)
    params = _extract_params(vol, 6.0, 16)
    before = cuda_lib.launch_counts["planes_extract"]
    k = launch_extract_kernel(vol.data, params)
    q = extract_planes_plain(vol.data, params)
    torch.cuda.synchronize()
    assert cuda_lib.launch_counts["planes_extract"] == before + 1
    assert int((q[:, :, :, 4] > 0.5).sum()) > 30
    assert torch.equal(k, q)


def _k7_grids(kind, dims, seed=0):
    """(tsdf, weight) float32 numpy grids of ``dims``: "empty" (nothing
    observed), "full" (every voxel observed, a wavy surface crossing every
    chunk, integer weights 1..15) or "one_subblock" (only sub-block 5 of
    chunk (1, 2, last) observed, on two rows in three, a tilted plane
    crossing it)."""
    rng = np.random.default_rng(seed)
    t = np.ones(dims, np.float32)
    w = np.zeros(dims, np.float32)
    if kind == "full":
        x, y, z = np.meshgrid(*(np.arange(d, dtype=np.float32) for d in dims), indexing="ij")
        t = np.clip(1.5 * np.sin(0.21 * x + 0.13 * y + 0.35 * z) +
                    rng.normal(0.0, 0.05, dims), -1.0, 1.0).astype(np.float32)
        w = rng.integers(1, 16, dims).astype(np.float32)
    elif kind == "one_subblock":
        z0 = (dims[2] // 128 - 1) * 128 + 5 * 8
        x, y, z = np.meshgrid(*(np.arange(8, dtype=np.float32),) * 3, indexing="ij")
        t[8:16, 16:24, z0:z0 + 8] = np.clip((z - 3.5 + 0.4 * x - 0.2 * y) / 3.0, -1.0, 1.0)
        w[8:16, 16:24, z0:z0 + 8] = np.where((x + y) % 3 == 0, 0.0,
                                             rng.integers(1, 9, (8, 8, 8)))
    return t, w


@pytest.mark.gpu
@pytest.mark.parametrize("dims", [(64, 64, 128), (128, 128, 256)], ids=["64x64x128", "128x128x256"])
@pytest.mark.parametrize("kind", ["empty", "full", "one_subblock"])
@pytest.mark.parametrize("dtype", LAYOUTS, ids=["packed", "float32"])
def test_extract_kernel_bit_identical_on_built_volumes(cuda, dtype, kind, dims):
    """K7 on an empty volume (every tile the all-zero shape), a fully
    observed one (every sub-block fitted) and one with a single observed
    sub-block (one tsdf fetch among unobserved chunks), in both layouts and
    at a non-cubic size (512 chunks: more than one a block of the
    persistent grid): every field of every chunk bit-identical."""
    t, w = (torch.from_numpy(g).to(cuda) for g in _k7_grids(kind, dims))
    vol = tsdf_new(dims[0], 3.0, 0.06, dtype=dtype, device=cuda)
    data = pack_tw(t, w) if dtype == torch.int32 else torch.stack([t, w])
    vol = vol._replace(data=data)
    params = _extract_params(vol, 6.0, dims[0] // 8)
    k = launch_extract_kernel(vol.data, params)
    q = extract_planes_plain(vol.data, params)
    torch.cuda.synchronize()
    assert k.shape == planes_shape(dims)
    n_valid = int((q[:, :, :, 4] > 0.5).sum())
    assert n_valid == 0 if kind == "empty" else n_valid >= 1
    if kind == "one_subblock":
        assert int((q[:, :, :, 5] > 0).sum()) == 1  # one sub-block with crossings
    assert torch.equal(k, q)


@pytest.mark.gpu
def test_dense_kernel_matches_plain(cuda):
    """K8 on frame 1 over a float32 volume carried from frame 0: volume,
    planes and chunk classes."""
    poses, frames = _stream(QQVGA, 2, 0.3, cuda)
    vol = tsdf_new(128, 3.0, 0.06, dtype=torch.float32, device=cuda)
    vol, _ = tsdf_integrate_with_planes(vol, frames[0], torch.from_numpy(poses[0]), QQVGA)
    mips, params = dense_inputs(vol, frames[1], torch.from_numpy(poses[1]), QQVGA)
    before = cuda_lib.launch_counts["tsdf_dense"]
    kd = vol.data.clone()
    kc, kp = launch_dense_kernel(kd, mips, params)
    qd = vol.data.clone()
    qc, qp = dense_integrate_plain(qd, mips, params)
    torch.cuda.synchronize()
    assert cuda_lib.launch_counts["tsdf_dense"] == before + 1
    assert int((qc > 0).sum()) > 50 and int(qd[1].max()) == 2
    assert torch.equal(kc, qc)
    assert torch.equal(kd, qd)
    assert torch.equal(kp, qp)


def _dense_matches_plain(vol, depth, pose, intr):
    """One K8 launch and its plain version on copies of ``vol``: classes,
    volume and planes bit-identical; lanes past R/8 zero. Returns (classes,
    planes)."""
    mips, params = dense_inputs(vol, depth, pose, intr)
    before = cuda_lib.launch_counts["tsdf_dense"]
    kd = vol.data.clone()
    kc, kp = launch_dense_kernel(kd, mips, params)
    qd = vol.data.clone()
    qc, qp = dense_integrate_plain(qd, mips, params)
    torch.cuda.synchronize()
    assert cuda_lib.launch_counts["tsdf_dense"] == before + 1
    assert torch.equal(kc, qc)
    assert torch.equal(kd, qd)
    assert torch.equal(kp, qp)
    assert not bool(kp[:, :, :, vol.dims[2] // 8 :].any())
    vol.data.copy_(kd)
    return kc, kp


@pytest.mark.gpu
@pytest.mark.parametrize("res", [128, 256, 512])
def test_dense_kernel_bit_identical_at_each_resolution(cuda, res):
    """K8 on the VGA orbit's frames 0 and 1 from a fresh float32 volume of
    R = 128, 256 and 512 (1, 2 and 4 chunks a column)."""
    poses, frames = _stream(VGA, 2, 0.04, cuda)
    vol = tsdf_new(res, 3.0, 0.03, dtype=torch.float32, device=cuda)
    for d, p in zip(frames, poses):
        kc, _ = _dense_matches_plain(vol, d, torch.from_numpy(p).to(cuda), VGA)
    assert int((kc != CLS_SKIP).sum()) > 20 and float(vol.data[1].max()) == 2.0


@pytest.mark.gpu
@pytest.mark.parametrize("res", [128, 256, 512])
@pytest.mark.parametrize("wall", ["boundary", "free"])
def test_dense_kernel_bit_identical_on_wall_frames(cuda, res, wall):
    """A flat wall facing the camera (constant depth), the camera 3 m before
    the cube's centre looking along +z. "boundary": the wall at the cube's
    centre, between voxels R/2 - 1 and R/2, a chunk boundary at R = 256
    and 512: its planes lie in sub-block R/16 - 1 only, from the +z
    crossing into the next chunk (the halo, after that chunk's integrate);
    columns out of view stay SKIP. "free": the wall beyond the cube, so
    every column in view is FREE. Each frame fused twice."""
    pose = torch.eye(4, device=cuda)
    pose[3, 2] = -3.0
    depth = torch.full((120, 160), 3.0 if wall == "boundary" else 4.6, device=cuda)
    vol = tsdf_new(res, 3.0, 0.06, dtype=torch.float32, device=cuda)
    nzc = res // 128
    for _ in range(2):
        kc, kp = _dense_matches_plain(vol, depth, pose, QQVGA)
    cols = kc.reshape(-1, nzc)
    valid = (kp[:, :, 4, : res // 8] > 0.5).sum(dim=(0, 1))
    if wall == "boundary":
        assert int(valid[res // 16 - 1]) > 100 and int(valid.sum()) == int(valid[res // 16 - 1])
        if res > 128:
            assert bool((cols == CLS_SKIP).all(dim=1).any())
    else:
        assert int((cols == CLS_FREE).all(dim=1).sum()) > 100
        assert int(valid.sum()) == 0


@pytest.mark.gpu
def test_dense_path_launches_its_kernels_only(cuda):
    """Path (B): two frames fused by K8, then model maps by raycast_pallas
    (K7, K6): those three launched, no other kernel and no plain version;
    the maps cover the view."""
    poses, frames = _stream(QQVGA, 2, 0.1, cuda)
    cuda_lib.reset_counts()
    vol = tsdf_new(128, 3.0, 0.06, dtype=torch.float32, device=cuda)
    for d, p in zip(frames, poses):
        vol, _ = tsdf_integrate_with_planes(vol, d, torch.from_numpy(p), QQVGA)
    maps = raycast_pallas(vol, torch.from_numpy(poses[0]).to(cuda), QQVGA)
    torch.cuda.synchronize()
    assert all(cuda_lib.launch_counts[k] > 0 for k in cuda_lib.DENSE_PATH)
    assert all(cuda_lib.launch_counts[k] == 0 for k in cuda_lib.KERNELS
               if k not in cuda_lib.DENSE_PATH)
    assert all(cuda_lib.plain_counts[k] == 0 for k in cuda_lib.KERNELS)
    assert float(maps[7].mean()) > 0.5


@pytest.mark.gpu
def test_raycast_kernel_bit_identical_on_curved_world(cuda):
    """K6 on the planes the kernel path fitted to the curved world
    (spheres, a capped cylinder, yaw-rotated boxes: the geometry its
    curvature trim and cliff exist for), after 4 tracked frames on a
    256^3 packed volume at 640x480: bit-identical to its plain version
    on all 9 rows."""
    from housescan_tpu_torch.kinfu.synthetic import curved_furnished_room

    half, boxes, spheres, cyls, obbs = curved_furnished_room()
    poses = orbit_poses(4, radius=0.25, yaw_range=0.08, pitch=0.25)
    frames = render_depth_stream(VGA, poses, half, boxes, spheres=spheres, cylinders=cyls,
                                 obbs=obbs, device=cuda)
    st = kinfu_init(VGA, resolution=256, size_m=3.0, trunc=0.03, init_pose=poses[0],
                    dtype=torch.int32, device=cuda)
    st, _ = kinfu_run(st, frames, VGA)
    assert bool(st.last_tracked)
    cand = build_tile_candidates(st.planes, st.pose, VGA, st.volume)
    params = _ray_params(st.pose, VGA, 0.3, 5)
    k = launch_raycast_kernel(cand, params, 480, 640)
    q = raycast_tiles_plain(cand, params, 480, 640)
    torch.cuda.synchronize()
    assert int((q[0] > 0).sum()) > 640 * 480 // 4
    assert torch.equal(k, q)


@pytest.mark.gpu
def test_noisy_frames_on_card_match_cpu(cuda):
    """The same seed draws the same noise for either device: the noise
    each adds (noisy frame minus clean frame) agrees to 1e-6 m, and the
    frames to 1e-5 m."""
    half, boxes = furnished_room()
    poses = orbit_poses(3, radius=0.25, yaw_range=0.3, pitch=0.25)
    got = {}
    for dev in (cuda, "cpu"):
        noisy = render_depth_stream(VGA, poses, half, boxes, noise=0.002, seed=3, device=dev)
        clean = render_depth_stream(VGA, poses, half, boxes, device=dev)
        assert noisy.device.type == torch.device(dev).type
        got[str(dev)] = (noisy.cpu(), (noisy.double() - clean.double()).cpu())
    (a, na), (b, nb) = got["cuda"], got["cpu"]
    assert float(nb.abs().max()) > 1e-4
    assert float((na - nb).abs().max()) <= 1e-6
    assert float((a - b).abs().max()) <= 1e-5


@pytest.mark.gpu
def test_room_stage_on_card_matches_cpu(cuda, tmp_path):
    """Two synthetic rooms through load, corners, cuboid fit, a move,
    wall connection, position optimisation and export, once with every
    scene on the card and once on the CPU: corners within 1e-4 m (as a
    point set: a cuboid's parametrisation is not unique), rmse within
    1e-5, optimised corner means within 1e-4 m, .xf matrices within 1e-5,
    placed points within 1e-4 m."""
    from housescan_tpu_torch.io.pcd import load_pcd
    from housescan_tpu_torch.io.xf import load_xf
    from housescan_tpu_torch.rooms import (
        Scene, WallRelation, connect_walls, export_all_room_xf_files, export_room_full_res,
        fit_cuboid_to_room, load_room, optimize_room_positions, suggest_corners, translate_room,
    )
    from housescan_tpu_torch.testing import make_synthetic_room_dir

    dirs = [make_synthetic_room_dir(tmp_path / f"room{i}", seed=i, noise=0.002,
                                    offset=np.array([4.3 * i, 0.0, 0.0])) for i in range(2)]
    out = {}
    for dev in ("cuda", "cpu"):
        scene = Scene(device=dev)
        rooms, rmses = [], []
        for d in dirs:
            room, rmse, _ = fit_cuboid_to_room(scene, suggest_corners(scene, load_room(scene, d)))
            rooms.append(room)
            rmses.append(rmse)
        scene.update_room(translate_room(scene.rooms[rooms[1].room_id],
                                         np.array([3.0, 0.0, 0.0], np.float32), device=dev))
        p0 = min(scene.rooms[rooms[0].room_id].planes, key=lambda p: p.normal[0])
        p1 = max(scene.rooms[rooms[1].room_id].planes, key=lambda p: p.normal[0])
        assert connect_walls(scene, p0.plane_id, p1.plane_id, WallRelation.opposite(0.1)) is not None
        results = optimize_room_positions(scene)
        xfs = export_all_room_xf_files(scene, tmp_path / f"xf_{dev}")
        placed = [load_pcd(export_room_full_res(scene.rooms[r.room_id], tmp_path / f"{dev}{k}.pcd",
                                                device=dev)).points
                  for k, r in enumerate(rooms)]
        final = [scene.rooms[r.room_id] for r in rooms]
        out[dev] = (final, rmses, results, [load_xf(x) for x in xfs], placed)
    (gr, grm, gres, gxf, gpl), (cr, crm, cres, cxf, cpl) = out["cuda"], out["cpu"]
    np.testing.assert_allclose(grm, crm, atol=1e-5)
    assert len(gres) == len(cres) >= 1
    for a, b in zip(gr, cr):
        ca, cb = (np.stack([c for _, c in r.corners]) for r in (a, b))
        dist = np.linalg.norm(ca[:, None] - cb[None], axis=-1)
        assert dist.min(axis=1).max() < 1e-4 and dist.min(axis=0).max() < 1e-4
        np.testing.assert_allclose(a.corner_mean(), b.corner_mean(), atol=1e-4)
    for a, b in zip(gxf, cxf):
        np.testing.assert_allclose(a, b, atol=1e-5)
    for a, b in zip(gpl, cpl):
        assert len(a) > 1000
        np.testing.assert_allclose(a, b, atol=1e-4)
