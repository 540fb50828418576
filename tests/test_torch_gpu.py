"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``gpu``: each test asks for the ``cuda`` fixture, which skips
where no CUDA device is present. Run them on the card with

    python -m pytest -m gpu tests/test_torch_*.py

Inputs come from the port's own synthetic module (no JAX). The library
builds with --fmad=false, so kernel and plain version run the same
float32 operations; they differ only in summation order. Bounds: K1
bit-identical (each pixel sums its taps in the plain version's order), at
odd sizes and every radius too; K11 (the pyramid after K1) bit-identical,
every level's depth and map rows as int32, at VGA, HD and an odd size, 1,
3 and 4 levels; K3 pose 5e-5, rmse 1e-4, correspondences max(5, n/200) (the
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
on SKIP and FREE columns and with a surface on a chunk boundary. K10 (the
mesh) bit-identical to the plain marching tetrahedra on the card: the
same vertex bytes, faces and count, on every layout, slab and cap. The
plane hulls' compiled chain byte for byte the Python chain on every case
of ``tests/hull_cases.py``, and on RANSAC's planes of a cloud on the
card. At
room-vga-1024 (1024^3 over 6 m, float32: 2^31 cells), one 3-frame scan
of the room-scan traffic through `portbench/drivers/scan.py` holds every
number of its cell's comparison with the plain reference
(``portbench/reference/scan.py``) within the cell's limits, and K6 is
bit-identical to its plain version on that volume's planes.
"""

import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch
from hull_cases import CASES as HULL_CASES
from hull_cases import room_cloud

from housescan_tpu_torch.kinfu import maps as mp
from housescan_tpu_torch.kinfu.camera import Intrinsics
from housescan_tpu_torch.kinfu.pipeline import kinfu_init, kinfu_run, kinfu_step
from housescan_tpu_torch.kinfu.preprocess import bilateral_filter, build_pyramid
from housescan_tpu_torch.kinfu.synthetic import furnished_room, orbit_poses, render_depth_stream
from housescan_tpu_torch.kinfu.tsdf import pack_tw, tsdf_new
from housescan_tpu_torch.utils.metrics import GLOBAL_METRICS
from housescan_tpu_torch.ops import cuda_lib
from housescan_tpu_torch.ops.chunk_select import CLS_FREE as WL_FREE
from housescan_tpu_torch.ops.chunk_select import CLS_REFINE, build_worklist
from housescan_tpu_torch.kinfu.icp import DAMPINGS
from housescan_tpu_torch.kinfu.marching_cubes import marching_cubes, marching_cubes_plain
from housescan_tpu_torch.kinfu.ransac import convex_hull_2d, detect_planes, plane_hulls, unique_hull
from housescan_tpu_torch.kinfu.scan import scan_to_room_dir
from housescan_tpu_torch.capture.replay import DepthStream
from housescan_tpu_torch.config import Config, TsdfConfig
from housescan_tpu_torch.kinfu.tsdf import TsdfVolume
from housescan_tpu_torch.ops.icp_cuda import (
    BAND_H,
    _plan,
    icp_level,
    icp_level_plain,
    icp_level_state,
)
from housescan_tpu_torch.ops.preprocess_cuda import bilateral_filter_cuda, bilateral_filter_plain
from housescan_tpu_torch.ops.pyramid_cuda import pyramid_cuda, pyramid_plain
from housescan_tpu_torch.ops.solve6 import solve_twist_compose, solve_twist_plain
from housescan_tpu_torch.ops.raycast_tiles import (
    _ray_params,
    build_tile_candidates,
    launch_raycast_kernel,
    raycast_tiles_plain,
)
from housescan_tpu_torch.ops.chunk_select import decode_free_worklist, launch_chunk_select
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


# K11's sizes: the orbit cells' cameras and a crop no block divides
PYRAMID_CAMS = {"640x480": VGA, "1280x720": Intrinsics(1280, 720, 674.4, 674.4, 639.5, 359.5),
                "161x121": Intrinsics(161, 121, 525.0, 525.0, 319.5, 239.5)}


def _pyramid_frame(device, intr, frame):
    """A raw frame at ``intr``'s size: the bench orbit's room; the room
    with holes and depth jumps over 0.08 m; or a smooth surface whose depth
    is valid on every border pixel and continuous across the wrap, so the
    normals' wrapped neighbours and the downsample's zero fill both act."""
    h, w = intr.height, intr.width
    if frame == "border":
        y, x = torch.meshgrid(torch.arange(h, device=device, dtype=torch.float32),
                              torch.arange(w, device=device, dtype=torch.float32), indexing="ij")
        return 2.0 + 0.03 * torch.sin(x * (2 * np.pi / w)) + 0.02 * torch.cos(y * (2 * np.pi / h))
    cam = intr if w != 161 else VGA
    d = _stream(cam, 1, 0.0, device)[1][0][:h, :w].clone()
    if frame == "holes":
        d[h // 3: h // 3 + h // 8, w // 4: w // 4 + w // 6] = 0.0  # a hole
        d[: h // 5] *= 1.25  # a jump of ~0.5 m along a row
        d[:, w // 2: w // 2 + 3] += 0.09  # two jumps just over the gate
        d[::7, ::5] = 0.0  # scattered dropouts
    return d


@pytest.mark.gpu
@pytest.mark.parametrize("frame", ["orbit", "holes", "border"])
@pytest.mark.parametrize("size", list(PYRAMID_CAMS))
def test_pyramid_kernel_bit_identical_to_plain(cuda, size, frame):
    """K11 against its plain version on K1's output, at levels 1, 3 and 4:
    every level's depth and all six map rows bit for bit (compared as
    int32, so a zero's sign counts); a call makes no host synchronisation
    and adds one to ``launch_counts["pyramid"]``."""
    intr = PYRAMID_CAMS[size]
    d0 = bilateral_filter_cuda(_pyramid_frame(cuda, intr, frame))
    for levels in (1, 3, 4):
        got_d, got_m = pyramid_cuda(d0, intr, levels)
        want_d, want_m = pyramid_plain(d0, intr, levels)
        assert len(got_d) == len(got_m) == levels and got_d[0] is d0
        for lvl in range(levels):
            shape = (intr.height >> lvl, intr.width >> lvl)
            assert got_d[lvl].shape == want_d[lvl].shape == shape
            assert got_m[lvl].shape == want_m[lvl].shape == (6, *shape)
            assert torch.equal(got_d[lvl].view(torch.int32), want_d[lvl].view(torch.int32)), lvl
            for row in range(6):
                assert torch.equal(got_m[lvl][row].view(torch.int32),
                                   want_m[lvl][row].view(torch.int32)), (lvl, row)
        assert bool((want_m[0][3:6] != 0).any())
    if frame == "border":  # every border pixel's normal, wrap and all
        assert bool((want_m[0][5][[0, -1]] != 0).all()) and bool((want_m[0][5][:, [0, -1]] != 0).all())
    torch.cuda.synchronize()
    before = dict(cuda_lib.launch_counts)
    torch.cuda.set_sync_debug_mode("error")
    try:
        pyramid_cuda(d0, intr, 3)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert cuda_lib.launch_counts == dict(before, pyramid=before["pyramid"] + 1)


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


@pytest.mark.gpu
def test_traced_step_waits_on_nothing_and_changes_nothing(cuda):
    """Four frames with the program's tracing on (``utils.metrics``), the
    last under PyTorch's sync debug mode: the spans and counters make the
    host wait on the card nowhere before ``drain``; the poses, volume and
    maps equal an untraced twin's bit for bit; the counters drained are
    the step's own (K3's iterations within each level's budget)."""
    poses, frames = _stream(QQVGA, 4, np.pi / 64, cuda)

    def fused(traced):
        st = kinfu_init(QQVGA, resolution=128, size_m=3.0, trunc=0.06, init_pose=poses[0],
                        device=cuda)
        if traced:
            GLOBAL_METRICS.enable()
        try:
            st, traj = kinfu_run(st, frames[:3], QQVGA)
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
            try:
                st = kinfu_step(st, frames[3], QQVGA)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        finally:
            GLOBAL_METRICS.disable()
        return st, traj

    GLOBAL_METRICS.drain()
    want, want_traj = fused(False)
    got, got_traj = fused(True)
    rec = GLOBAL_METRICS.drain()
    assert torch.equal(got_traj, want_traj) and torch.equal(got.pose, want.pose)
    assert torch.equal(got.volume.data, want.volume.data)
    assert torch.equal(got.model_maps, want.model_maps) and torch.equal(got.planes, want.planes)
    frames_ = [sp.frame for sp in rec["spans"] if sp.name == "step"]
    assert len(frames_) == 4
    last = {c.name: c.value for c in rec["counters"] if c.frame == frames_[-1]}
    for k, budget in enumerate((10, 5, 4)):
        assert 1 <= last[f"icp.level{k}.iterations"] <= budget
        assert isinstance(last[f"icp.level{k}.corr"], int)
    assert last["integrate.listed_chunks"] > 0 and last["integrate.free_superblocks"] >= 1
    names = {sp.name for sp in rec["spans"] if sp.frame == frames_[-1]}
    assert {"track.icp.level0", "integrate.stream", "integrate.free", "raycast.tiles"} <= names


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


def _k9_flags(planes, seed=0):
    """``planes`` with random saturation flags (a quarter in 4) and
    negative flags (a chunk in 10) OR'ed into field 11, so every flag path
    of the prepass runs."""
    g = torch.Generator(device=planes.device).manual_seed(seed)
    out = planes.clone()
    f = out[:, :, :, FIELD_SAT, :N_QUARTERS + 1]
    odds = torch.tensor([0.25] * N_QUARTERS + [0.1], device=planes.device)
    rnd = (torch.rand(f.shape, generator=g, device=planes.device) < odds).float()
    out[:, :, :, FIELD_SAT, :N_QUARTERS + 1] = torch.maximum(f, rnd)
    return out


def _k9_room(cuda, intr, yaw=0.3):
    """A 512^3 packed volume (the main path's 16,384 chunks) with one fused
    orbit frame at ``intr``, its planes with random flags OR'ed in, and
    the next frame with its pose."""
    poses, frames = _stream(intr, 2, yaw, cuda)
    vol = tsdf_new(512, 3.0, 0.03, dtype=torch.int32, device=cuda)
    planes = torch.zeros(planes_shape(512), device=cuda)
    tsdf_integrate_stream(vol, planes, frames[0], torch.from_numpy(poses[0]).to(cuda), intr)
    return vol, _k9_flags(planes), frames[1], torch.from_numpy(poses[1]).to(cuda)


def _k9_edges(cuda, fx, fy, band):
    """Chunk (0, 0, 0) of a 128^3 volume at (0, 0, 1) m, 1/128 m voxels,
    seen from the identity pose with cx = cy = 0: its first z-quarter's
    image box is [0, fx / 16] x [0, fy / 16] exactly, and its band window
    (quarters 0-2) the same. Depth 1.5 m everywhere but, with ``band``,
    0.5 m on the columns [2 s, 4 s), s = max(fx, fy) / 16: in the dilated
    footprint of the next level up, not of the quarter's own level; the
    quarter's saturation flag then makes its level decide whether it
    counts as behind."""
    intr = Intrinsics(640, 480, fx, fy, 0.0, 0.0)
    vol = tsdf_new(128, 1.0, 0.03, origin=torch.tensor([0.0, 0.0, 1.0]), dtype=torch.int32,
                   device=cuda)
    depth = torch.full((480, 640), 1.5, device=cuda)
    planes = torch.zeros(planes_shape(128), device=cuda)
    if band:
        s = int(max(fx, fy) / 16)
        depth[:, 2 * s : 4 * s] = 0.5
        planes[:, :, :, FIELD_SAT, 0] = 1.0
    return vol, planes, depth, torch.eye(4, device=cuda), intr


def _k9_matches_plain(vol, planes, depth, pose, intr, dims, bx0=0, free_split=True):
    """K9 and ``build_worklist`` on the same inputs (the flags from
    ``planes`` field 11): every row of ``desc``, ``count`` and every field
    of the free list identical. Returns K9's (WorkList, FreeWorkList)."""
    params = _stream_params(vol, pose, intr, 128.0, dims[0] // 8, dims[2] // 128, bx0)
    before = cuda_lib.launch_counts["chunk_select"]
    wl, fwl = launch_chunk_select(depth, planes, params, intr, dims, free_split)
    assert cuda_lib.launch_counts["chunk_select"] == before + 1
    sat = planes[:, :, :, FIELD_SAT, :N_QUARTERS].reshape(-1, N_QUARTERS) > 0.5
    geom = (depth, pose, intr, dims, vol.voxel_size, vol.origin, vol.trunc)
    if free_split:
        neg = planes[:, :, :, FIELD_SAT, N_QUARTERS].reshape(-1) > 0.5
        pwl, pfwl = build_worklist(*geom, sat_quarters=sat, block_x0=bx0, neg_flags=neg,
                                   free_split=True)
    else:
        pwl, pfwl = build_worklist(*geom, sat_quarters=sat, block_x0=bx0), None
    torch.cuda.synchronize()
    bad = (wl.desc != pwl.desc).any(dim=1).nonzero()[:4, 0].tolist()
    assert not bad, (f"rows {bad} differ: K9 {wl.desc[bad].tolist()}, plain "
                     f"{pwl.desc[bad].tolist()}; counts {int(wl.count[0])} / {int(pwl.count[0])}")
    assert torch.equal(wl.count, pwl.count)
    assert (fwl is None) == (pfwl is None)
    if fwl is not None:
        for name, a, b in zip(fwl._fields, fwl, pfwl):
            assert torch.equal(a, b), f"free list {name} differs"
    return wl, fwl


K9_CASES = ["vga", "hd720", "slab", "unsplit", "nbx_not_div4", "all_invalid", "all_valid",
            "refine", "level_edges", "window_edges"]


@pytest.mark.gpu
@pytest.mark.parametrize("case", K9_CASES)
def test_chunk_select_kernel_bit_identical_to_plain(cuda, case):
    """K9 against the plain ``build_worklist`` on the card, bit for bit on
    every row of ``desc``, ``count`` and every free-list field: the main
    path's VGA and HD frames on a fused room with saturation and negative
    flags set; an X-slab (block_x0 16, 128 x 512 x 512); the free split
    off; x chunks not divisible by 4 (no free list); an all-invalid frame
    (nothing FREE, a zero-padded free list) and an all-valid one (the
    free_global branch); the orbit's camera inside the volume, whose
    plane cuts chunks, with holes in the frame (REFINE rows); image boxes exactly at the footprint
    levels' edges (8 2^l px) and the band window's (22 / 60, 44 / 120 px),
    and one float32 step above each."""
    if case in ("vga", "hd720", "refine"):
        vol, planes, d, p = _k9_room(cuda, HD720 if case == "hd720" else VGA)
        if case == "refine":
            # a hole in the frame: a quarter cut by the camera plane is then
            # neither free (the image is not all valid) nor behind: it refines
            d = d.clone()
            d[:16, :16] = 0.0
        wl, fwl = _k9_matches_plain(vol, planes, d, p, HD720 if case == "hd720" else VGA,
                                    vol.dims)
        n = int(wl.count[0])
        assert n > 500
        if case == "refine":
            assert int((wl.desc[:n, 3] == CLS_REFINE).sum()) > 0
        else:
            assert int(fwl.count[0]) > 10
    elif case == "slab":
        vol, planes, d, p = _k9_room(cuda, VGA)
        slab = vol._replace(data=vol.data[128:256].contiguous())
        wl, fwl = _k9_matches_plain(slab, planes[16:32].contiguous(), d, p, VGA, slab.dims,
                                    bx0=16)
        assert int(wl.count[0]) > 50
    elif case == "unsplit":
        vol, planes, d, p = _k9_room(cuda, VGA)
        wl, fwl = _k9_matches_plain(vol, planes, d, p, VGA, vol.dims, free_split=False)
        assert fwl is None and int(wl.count[0]) > 500
    elif case == "nbx_not_div4":
        poses, frames = _stream(VGA, 2, 0.3, cuda)
        base = tsdf_new(128, 0.75, 0.03, origin=torch.tensor([-0.14, -0.19, 0.5]),
                        dtype=torch.int32, device=cuda)
        vol = base._replace(data=torch.zeros((48, 64, 128), dtype=torch.int32, device=cuda))
        planes = _k9_flags(torch.zeros(planes_shape(vol.dims), device=cuda))
        wl, fwl = _k9_matches_plain(vol, planes, frames[1], torch.from_numpy(poses[1]).to(cuda),
                                    VGA, vol.dims)
        assert fwl is None and int(wl.count[0]) > 10
    elif case in ("all_invalid", "all_valid"):
        vol, planes, d, p = _k9_room(cuda, VGA)
        d = torch.zeros_like(d) if case == "all_invalid" else torch.full_like(d, 2.0)
        wl, fwl = _k9_matches_plain(vol, planes, d, p, VGA, vol.dims)
        if case == "all_invalid":
            # nothing is FREE, so no superblock is listed; chunks whose box is
            # cut by the camera plane or spans past a level-4 cell stay listed
            n = int(wl.count[0])
            assert int((wl.desc[:n, 3] == WL_FREE).sum()) == 0 and int(fwl.count[0]) == 1
            assert not any(bool(f.any()) for f in (fwl.bitmap, fwl.bi, fwl.bj, fwl.bk))
        else:
            assert int(fwl.count[0]) > 10
    elif case == "level_edges":
        # PyTorch's float32 log2 on the card gives the least l with
        # max(span, 1) <= 8 2^l (K9's rule) at and beside the powers of two
        spans = [np.float32(8 * 2 ** l) for l in range(5)]
        spans += [np.nextafter(s, np.float32(np.inf)) for s in spans]
        spans += [np.nextafter(s, np.float32(0)) for s in spans[:5]]
        t = torch.tensor(np.array(spans, dtype=np.float32), device=cuda)
        lvl = torch.clamp(torch.ceil(torch.log2(torch.clamp(t, min=1.0) / 8.0)), 0, 4)
        rule = [next((l for l in range(4) if s <= 8 * 2 ** l), 4) for s in spans]
        assert lvl.long().tolist() == rule
        for l in range(4):
            f = np.float32(128 * 2 ** l)
            for fx in (f, np.nextafter(f, np.float32(np.inf))):
                vol, planes, d, p, intr = _k9_edges(cuda, float(fx), float(fx), band=True)
                _k9_matches_plain(vol, planes, d, p, intr, vol.dims)
    else:  # window_edges: chunk (0, 0, 0) is listed first, BAND, at level 0 or just past it
        up = lambda v: float(np.nextafter(np.float32(v), np.float32(np.inf)))  # noqa: E731
        for fx, fy, level in ((960.0, 352.0, 0), (up(960.0), 352.0, 1), (960.0, up(352.0), 1),
                              (1920.0, 704.0, 1), (up(1920.0), 704.0, 2),
                              (1920.0, up(704.0), 2)):
            vol, planes, d, p, intr = _k9_edges(cuda, fx, fy, band=False)
            wl, _ = _k9_matches_plain(vol, planes, d, p, intr, vol.dims)
            assert wl.desc[0, :5].tolist() == [0, 0, 0, 1, level]


@pytest.mark.gpu
def test_chunk_select_kernel_launches_once_a_step(cuda):
    """Two steps of the kernel path after the first: K9's launch count
    rises by one a step and no plain version runs; a profiled step runs
    K9's three device kernels once each."""
    poses, frames = _stream(QQVGA, 4, np.pi / 64, cuda)
    st = kinfu_init(QQVGA, resolution=128, size_m=3.0, trunc=0.06, init_pose=poses[0],
                    device=cuda)
    st = kinfu_step(st, frames[0], QQVGA)
    for k in (1, 2):
        launched, plain = dict(cuda_lib.launch_counts), dict(cuda_lib.plain_counts)
        st = kinfu_step(st, frames[k], QQVGA)
        assert cuda_lib.launch_counts["chunk_select"] == launched["chunk_select"] + 1
        assert cuda_lib.plain_counts == plain
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        st = kinfu_step(st, frames[3], QQVGA)
        torch.cuda.synchronize()
    k9 = {e.key.split("_kernel")[0].split("chunk_")[-1]: e.count for e in prof.key_averages()
          if "chunk_" in e.key and "_kernel" in e.key}
    assert k9 == {"hiz": 1, "classify": 1, "compact": 1}


def _k10(vol, **kw):
    """K10's mesh of the CUDA volume ``vol`` (its launch and plain counts
    of the call checked: 1 and 0), and the plain version's on the card."""
    cuda_lib.reset_counts()
    got = marching_cubes(vol, **kw)
    assert (cuda_lib.launch_counts["marching_tets"], cuda_lib.plain_counts["marching_tets"]) == (1, 0)
    return got, marching_cubes_plain(vol, **kw)


def _same_soup(got, want, min_triangles):
    """The same vertex bytes, the same faces, the same count."""
    assert got.vertices.dtype == np.float32 and got.vertices.shape == want.vertices.shape
    assert got.vertices.tobytes() == want.vertices.tobytes()
    np.testing.assert_array_equal(got.faces, want.faces)
    assert len(got.faces) >= min_triangles


def _k10_box(device):
    """test_torch_tracing's 64^3 volume: the inside of a 0.6 m box over 1
    m, every voxel observed."""
    vol = tsdf_new(64, 1.0, 0.03, device=device)
    c = (torch.arange(64, dtype=torch.float32, device=device) + 0.5) / 64 - 0.5
    x, y, z = torch.meshgrid(c, c, c, indexing="ij")
    inside = 0.3 - torch.maximum(torch.maximum(x.abs(), y.abs()), z.abs())
    vol.data[0] = torch.clamp(inside / 0.03, -1.0, 1.0)
    vol.data[1] = 1.0
    return vol


def _k10_sphere(device, dims, slab_weights=False):
    """A sphere of 0.9 m over a 3 m box of ``dims`` voxels (float32),
    every voxel observed; with ``slab_weights`` the weights run 0-3 by x
    and y (a quarter of the cells unobserved, a quarter at 1)."""
    axes = [(torch.arange(n, dtype=torch.float32, device=device) + 0.5) * (3.0 / n) - 1.5
            for n in dims]
    gx, gy, gz = torch.meshgrid(*axes, indexing="ij")
    t = torch.clamp((0.9 - torch.sqrt(gx * gx + gy * gy + gz * gz)) / 0.15, -1.0, 1.0)
    w = torch.ones(dims, device=device)
    if slab_weights:
        ix = torch.arange(dims[0], device=device)[:, None, None]
        iy = torch.arange(dims[1], device=device)[None, :, None]
        w = ((ix // 5 + iy // 7) % 4).to(torch.float32).expand(dims).contiguous()
    return TsdfVolume(torch.stack([t, w]), torch.full((3,), -1.5, device=device),
                      torch.tensor(3.0 / dims[0], device=device), torch.tensor(0.15, device=device))


def _k10_fused(cuda, dtype):
    """A 128^3 volume over 3 m of ``dtype`` (float32, packed int32 or
    bfloat16) with 4 orbit frames fused by the kernel path: partly
    observed, weights 1-4."""
    poses, frames = _stream(QQVGA, 4, np.pi / 16, cuda)
    st = kinfu_init(QQVGA, resolution=128, size_m=3.0, trunc=0.06, init_pose=poses[0],
                    dtype=dtype, device=cuda)
    st, _ = kinfu_run(st, frames, QQVGA)
    return st.volume


@pytest.mark.gpu
def test_marching_tets_bit_identical_on_the_box(cuda):
    got, want = _k10(_k10_box(cuda))
    _same_soup(got, want, 1000)
    # and the CPU call takes the plain version: the counts the other way round
    cuda_lib.reset_counts()
    cpu = marching_cubes(_k10_box("cpu"))
    assert (cuda_lib.launch_counts["marching_tets"], cuda_lib.plain_counts["marching_tets"]) == (0, 1)
    assert len(cpu.faces) == len(got.faces)


@pytest.mark.gpu
@pytest.mark.parametrize("slab", [8, 16, 127])
def test_marching_tets_bit_identical_on_a_fused_volume(cuda, slab):
    vol = _k10_fused(cuda, torch.float32)
    got, want = _k10(vol, slab=slab)
    _same_soup(got, want, 1000)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.int32, torch.bfloat16], ids=["packed", "bf16"])
@pytest.mark.parametrize("min_weight", [1.0, 2.0])
def test_marching_tets_bit_identical_on_each_layout(cuda, dtype, min_weight):
    """The packed int32 and bfloat16 layouts, read through the storage
    templates, and the fused volume's unobserved and once-seen cells
    under min_weight 1 and 2."""
    got, want = _k10(_k10_fused(cuda, dtype), min_weight=min_weight)
    _same_soup(got, want, 500)


@pytest.mark.gpu
@pytest.mark.parametrize("dims,slab", [((48, 48, 48), 16), ((48, 40, 72), 16), ((70, 33, 97), 9)],
                         ids=["48-clamped", "48x40x72", "70x33x97"])
@pytest.mark.parametrize("slab_weights", [False, True], ids=["observed", "weights-0-3"])
def test_marching_tets_bit_identical_at_odd_dims(cuda, dims, slab, slab_weights):
    """Dims whose last slab is clamped (47 cells in slabs of 16 or 9 and
    69 of 9), rows that do not fill a 32-cell word or an 8-row unit, and
    weights 0-3 under min_weight 1 and 2 (weights all 1: none passes 2)."""
    vol = _k10_sphere(cuda, dims, slab_weights)
    for mw in (1.0, 2.0):
        got, want = _k10(vol, slab=slab, min_weight=mw)
        _same_soup(got, want, 50 if slab_weights else 300 if mw == 1.0 else 0)
        if not slab_weights and mw == 2.0:
            assert len(got.faces) == 0


@pytest.mark.gpu
def test_marching_tets_cap_keeps_the_first_triangles(cuda, capsys):
    vol = _k10_box(cuda)
    full, _ = _k10(vol)
    n = len(full.faces)
    assert capsys.readouterr().err == ""
    cap = n // 3
    got, want = _k10(vol, max_triangles=cap)
    err = capsys.readouterr().err
    line = f"marching_cubes: {n} triangles exceed capacity {cap}; mesh truncated (raise max_triangles)"
    assert err.splitlines() == [line, line]  # K10's, then the plain version's
    _same_soup(got, want, cap)
    assert len(got.faces) == cap
    assert got.vertices.tobytes() == full.vertices[: 3 * cap].tobytes()
    got, _ = _k10(vol, max_triangles=n)
    assert len(got.faces) == n and capsys.readouterr().err == ""


@pytest.mark.gpu
def test_marching_tets_empty_volumes(cuda):
    """An unobserved volume and an observed one with no surface: no
    triangles, one K10 call each."""
    empty = tsdf_new(64, 1.0, 0.03, device=cuda)
    got, want = _k10(empty)
    assert len(got.faces) == len(want.faces) == 0 and got.vertices.shape == (0, 3)
    free = _k10_box(cuda)
    free.data[0] = 1.0
    got, _ = _k10(free)
    assert len(got.faces) == 0


@pytest.mark.gpu
def test_marching_tets_waits_on_the_card_for_the_count_and_the_copy(cuda):
    """PyTorch's sync debug mode sees the host wait on the card twice in
    a call: the triangle count (to size the output) and the copy of the
    triangles to the host."""
    import warnings

    vol = _k10_box(cuda)
    marching_cubes(vol)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            marching_cubes(vol)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    syncs = [(Path(w.filename).name, w.lineno) for w in caught
             if "called a synchronizing" in str(w.message)]
    assert len(syncs) == 2 and all(f == "marching_tets.py" for f, _ in syncs), syncs


# --- the plane hulls' compiled chain ----------------------------------------


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(HULL_CASES))
def test_convex_hull_compiled_byte_identical(cuda, case):
    """The compiled chain against the Python chain on each shared case
    (``tests/hull_cases.py``): one compiled call, its dedupe gives
    ``np.unique``'s bytes, and its hull the Python chain's rows, dtype and
    shape, byte for byte."""
    x = HULL_CASES[case]()
    launched = cuda_lib.launch_counts["convex_hull"]
    pts, got = unique_hull(x, compiled=True)
    assert cuda_lib.launch_counts["convex_hull"] == launched + 1
    unique = np.unique(np.asarray(x, np.float64), axis=0)
    assert pts.shape == unique.shape and pts.tobytes() == unique.tobytes()
    want = convex_hull_2d(x)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert got.tobytes() == want.tobytes()


@pytest.mark.gpu
def test_plane_hulls_of_a_cloud_on_the_card_equal_the_python_chain(cuda):
    """RANSAC's planes of a room cloud on the card: ``plane_hulls`` of the
    CUDA cloud makes one compiled chain call a plane and no Python one, and
    its hulls are those of the same cloud as numpy (the Python chain), byte
    for byte."""
    cloud = room_cloud()
    points = torch.from_numpy(cloud).to(cuda)
    det = detect_planes(points, min_inliers=200)
    n_planes = int(det.n_planes)
    assert n_planes == 4
    launched, plain = cuda_lib.launch_counts["convex_hull"], cuda_lib.plain_counts["convex_hull"]
    got = plane_hulls(points, det)
    assert cuda_lib.launch_counts["convex_hull"] - launched == n_planes
    assert cuda_lib.plain_counts["convex_hull"] == plain
    want = plane_hulls(cloud, det)
    assert cuda_lib.plain_counts["convex_hull"] - plain == n_planes
    assert len(got) == len(want) == n_planes
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape and len(g) >= 4
        assert g.tobytes() == w.tobytes()


@pytest.mark.gpu
def test_scan_on_the_card_takes_the_compiled_hulls(cuda, tmp_path):
    """A traced 4-frame 128^3 scan on the card: one compiled chain call a
    plane of its planes.txt and no Python one, the span
    ``export.ransac.hulls`` inside ``export.ransac``, and
    ``export.hull_points`` counted once, at most the downsampled points."""
    poses, frames = _stream(QQVGA, 4, np.pi / 64, cuda)
    config = Config(tsdf=TsdfConfig(resolution=128, size_m=3.0, trunc_dist=0.06))
    cuda_lib.reset_counts()
    GLOBAL_METRICS.drain()
    GLOBAL_METRICS.enable()
    try:
        room = scan_to_room_dir(DepthStream(frames=frames.cpu().numpy(), intrinsics=QQVGA),
                                tmp_path / "room", config=config, init_pose=poses[0],
                                downsample_to=4096, device=cuda)
    finally:
        GLOBAL_METRICS.disable()
    rec = GLOBAL_METRICS.drain()
    n_planes = len((room / "planes.txt").read_text().split()) // 4
    assert n_planes >= 2
    assert cuda_lib.launch_counts["convex_hull"] == n_planes
    assert cuda_lib.plain_counts["convex_hull"] == 0
    spans = rec["spans"]
    hulls = [s for s in spans if s.name == "export.ransac.hulls"]
    assert len(hulls) == 1 and spans[hulls[0].parent].name == "export.ransac"
    counts = [c.value for c in rec["counters"] if c.name == "export.hull_points"]
    assert len(counts) == 1 and 4 * n_planes <= counts[0] <= 4096


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


# --- the bfloat16 volume and the slab offset ---------------------------------


def _random_bf16_volume(cuda, res=128, seed=0):
    """A (2, res, res, res) bfloat16 volume of random cells: the tsdf
    uniform in [-1, 1], the weights integers 0..20 (a third of them 0)."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    t = torch.rand((res,) * 3, generator=g) * 2.0 - 1.0
    w = torch.randint(0, 21, (res,) * 3, generator=g).float()
    w = torch.where(torch.rand((res,) * 3, generator=g) < 0.33, 0.0, w)
    vol = tsdf_new(res, 3.0, 0.06, dtype=torch.bfloat16, device=cuda)
    return vol._replace(data=torch.stack([t, w]).to(torch.bfloat16).to(cuda))


@pytest.fixture(params=["fused", "random"])
def bf16_volume(cuda, request):
    """A 128^3 bfloat16 volume (one fused frame, or random cells) with its
    planes, and the next frame's inputs."""
    poses, frames = _stream(QQVGA, 2, 0.3, cuda)
    if request.param == "fused":
        vol = tsdf_new(128, 3.0, 0.06, dtype=torch.bfloat16, device=cuda)
    else:
        vol = _random_bf16_volume(cuda)
    planes = torch.zeros(planes_shape(128), device=cuda)
    tsdf_integrate_stream(vol, planes, frames[0], torch.from_numpy(poses[0]).to(cuda), QQVGA)
    return vol, planes, frames[1], torch.from_numpy(poses[1]).to(cuda)


@pytest.mark.gpu
def test_bf16_stream_kernel_bit_identical(bf16_volume):
    """K4 on the bfloat16 layout: float32 math, stores rounded to nearest
    even in both: volume and planes bit-identical to the plain version."""
    vol, planes, d, p = bf16_volume
    sat = planes[:, :, :, FIELD_SAT, :4].reshape(-1, 4) > 0.5
    wl = build_worklist(d, p, QQVGA, 128, vol.voxel_size, vol.origin, vol.trunc, sat_quarters=sat)
    mips = build_depth_mips(d)
    params = _stream_params(vol, p, QQVGA, 128.0, 16, 1)
    kd, kp = vol.data.clone(), planes.clone()
    launch_stream_kernel(kd, kp, wl.desc, wl.count, mips, params)
    qd, qp = vol.data.clone(), planes.clone()
    integrate_plain(qd, qp, wl.desc, wl.count, mips, params, 16, 1)
    torch.cuda.synchronize()
    assert int((kd != vol.data).sum()) > 1000
    assert int((qp[:, :, :, 5] > 0).sum()) > 30  # sub-blocks with crossings fitted
    assert torch.equal(kd, qd)
    assert torch.equal(kp, qp)


@pytest.mark.gpu
@pytest.mark.parametrize("cells", ["carved", "random"])
def test_bf16_free_kernel_bit_identical(cuda, cells):
    """K5 on the bfloat16 layout (8-byte vectors of 4 cells), on the
    carved scene and with the same free list over random cells."""
    vol, planes, fwl, params = _carved_free_list(cuda, torch.bfloat16)
    if cells == "random":
        vol = vol._replace(data=_random_bf16_volume(cuda, seed=1).data)
    kd, kp = vol.data.clone(), planes.clone()
    launch_free_kernel(kd, kp, fwl, params)
    qd, qp = vol.data.clone(), planes.clone()
    free_carve_plain(qd, qp, fwl, params)
    torch.cuda.synchronize()
    assert int((kd != vol.data).sum()) > 1000
    assert torch.equal(kd, qd)
    assert torch.equal(kp, qp)


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["fused", "full", "one_subblock"])
def test_bf16_extract_kernel_bit_identical(cuda, kind):
    """K7 on the bfloat16 layout: two fused frames, and the built volumes
    of ``_k7_grids`` rounded to bfloat16 at a non-cubic size."""
    if kind == "fused":
        poses, frames = _stream(QQVGA, 2, 0.3, cuda)
        vol = tsdf_new(128, 3.0, 0.06, dtype=torch.bfloat16, device=cuda)
        planes = torch.zeros(planes_shape(128), device=cuda)
        for d, p in zip(frames, poses):
            tsdf_integrate_stream(vol, planes, d, torch.from_numpy(p).to(cuda), QQVGA)
    else:
        dims = (128, 128, 256)
        t, w = (torch.from_numpy(g).to(cuda) for g in _k7_grids(kind, dims))
        vol = tsdf_new(128, 3.0, 0.06, dtype=torch.bfloat16, device=cuda)
        vol = vol._replace(data=torch.stack([t, w]).to(torch.bfloat16))
    params = _extract_params(vol, 6.0, vol.dims[0] // 8)
    k = launch_extract_kernel(vol.data, params)
    q = extract_planes_plain(vol.data, params)
    torch.cuda.synchronize()
    assert int((q[:, :, :, 4] > 0.5).sum()) >= 1
    assert torch.equal(k, q)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.int32, torch.float32, torch.bfloat16],
                         ids=["packed", "float32", "bfloat16"])
def test_slab_kernels_match_plain_and_whole_volume(cuda, dtype):
    """K5 then K4 on an X-slab (X blocks 4..7 of 16) with its offset: the
    kernels equal their plain versions, and the slab equals the same
    X-range of the whole volume integrated by the plain versions."""
    vol, planes, poses, frames = _carved_scene(cuda, 3, dtype)
    for k in range(2):
        tsdf_integrate_stream(vol, planes, frames[k], torch.from_numpy(poses[k]).to(cuda), QQVGA)
    p2 = torch.from_numpy(poses[2]).to(cuda)
    whole = vol._replace(data=vol.data.cpu().clone(), origin=vol.origin.cpu(),
                         voxel_size=vol.voxel_size.cpu(), trunc=vol.trunc.cpu())
    whole_planes = planes.cpu().clone()
    tsdf_integrate_stream(whole, whole_planes, frames[2].cpu(), p2.cpu(), QQVGA)
    xs = slice(32, 64)
    cut = (lambda a: a[xs]) if dtype == torch.int32 else (lambda a: a[:, xs])
    slab = vol._replace(data=cut(vol.data).contiguous())
    slab_planes = planes[4:8].contiguous()
    sat = slab_planes[:, :, :, FIELD_SAT, :4].reshape(-1, 4) > 0.5
    neg = slab_planes[:, :, :, FIELD_SAT, 4].reshape(-1) > 0.5
    wl, fwl = build_worklist(frames[2], p2, QQVGA, slab.dims, vol.voxel_size, vol.origin,
                             vol.trunc, sat_quarters=sat, block_x0=4, neg_flags=neg,
                             free_split=True)
    assert int(wl.count[0]) >= 1
    params = _stream_params(slab, p2, QQVGA, 128.0, 16, 1, 4)
    mips = build_depth_mips(frames[2])
    kd, kp = slab.data.clone(), slab_planes.clone()
    launch_free_kernel(kd, kp, fwl, params)
    launch_stream_kernel(kd, kp, wl.desc, wl.count, mips, params)
    qd, qp = slab.data.clone(), slab_planes.clone()
    free_carve_plain(qd, qp, fwl, params, 4)
    integrate_plain(qd, qp, wl.desc, wl.count, mips, params, 16, 1, 4)
    torch.cuda.synchronize()
    assert int((kd != slab.data).sum()) > 1000
    assert torch.equal(kd, qd) and torch.equal(kp, qp)
    assert torch.equal(kd.cpu(), cut(whole.data)) and torch.equal(kp.cpu(), whole_planes[4:8])


@pytest.mark.gpu
def test_sharded_step_on_one_card_bit_identical_to_single(cuda):
    """The 4-slab sharded kernel-path step on cuda:0, teacher-forced from
    the single-device state for 3 frames at 128^3: pose, volume, planes,
    model vertices and valid mask bit-identical; normals within the
    reference's bound (< 5e-3, under 1% of pixels over 1e-4: a tie between
    slabs takes each component's max)."""
    from housescan_tpu_torch.parallel import make_mesh
    from housescan_tpu_torch.parallel.sharded import (
        make_sharded_step,
        sharded_state_from_single,
        single_state_from_sharded,
    )

    poses, frames = _stream(QQVGA, 3, 0.06, cuda)
    mesh = make_mesh(4, devices=[cuda] * 4)
    step = make_sharded_step(mesh, QQVGA, iterations=(10, 5, 4), use_pallas=True)
    ref = kinfu_init(QQVGA, resolution=128, size_m=3.0, trunc=0.06, init_pose=poses[0],
                     dtype=torch.int32, device=cuda)
    cuda_lib.reset_counts()
    for k in range(3):
        sh = single_state_from_sharded(step(sharded_state_from_single(mesh, ref, True),
                                            frames[k]))
        ref = kinfu_step(ref, frames[k], QQVGA)
        torch.cuda.synchronize()
        assert torch.equal(sh.pose, ref.pose)
        assert torch.equal(sh.volume.data, ref.volume.data)
        assert torch.equal(sh.planes, ref.planes)
        assert torch.equal(sh.model_maps[mp.MD_V], ref.model_maps[mp.MD_V])
        assert torch.equal(sh.model_maps[mp.MD_VALID], ref.model_maps[mp.MD_VALID])
        dn = (sh.model_maps[mp.MD_N] - ref.model_maps[mp.MD_N]).abs()
        assert float(dn.max()) < 5e-3
        assert int((dn.amax(0) > 1e-4).sum()) < dn[0].numel() // 100
    assert all(cuda_lib.launch_counts[k] > 0 for k in cuda_lib.KERNEL_PATH)
    assert all(cuda_lib.plain_counts[k] == 0 for k in cuda_lib.KERNELS)


@pytest.mark.gpu
@pytest.mark.parametrize("use_pallas", [True, False], ids=["kernel_path", "xla_path"])
def test_step_on_a_second_card_bit_identical_to_the_first(cuda, use_pallas):
    """Three steps on cuda:1 while cuda:0 is the current device: each
    kernel of the path (K1, K3-K6; K1, K2 on the XLA path) launches on
    the card of its tensors, and the state is the one cuda:0 gives, bit
    for bit. Skips with fewer than two cards."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two or more CUDA devices")
    poses, frames = _stream(QQVGA, 3, 0.06, "cpu")
    out = []
    for dev in (torch.device("cuda", 0), torch.device("cuda", 1)):
        st = kinfu_init(QQVGA, resolution=128, size_m=3.0, trunc=0.06, init_pose=poses[0],
                        dtype=torch.int32, device=dev)
        with torch.cuda.device(0):
            for d in frames:
                st = kinfu_step(st, d.to(dev), QQVGA, use_pallas=use_pallas)
        torch.cuda.synchronize(dev)
        out.append(st)
    a, b = out
    assert b.volume.data.device == torch.device("cuda", 1)
    for x, y in ((a.pose, b.pose), (a.volume.data, b.volume.data), (a.planes, b.planes),
                 (a.model_maps, b.model_maps)):
        assert torch.equal(x.cpu(), y.cpu())
    assert int((a.volume.data & 0xFFFF).count_nonzero()) > 10000


@pytest.mark.gpu
def test_sharded_step_on_several_cards_bit_identical_to_single(cuda):
    """The sharded step with one slab a card (``make_mesh(n)`` over the
    first n <= 4 visible cards), teacher-forced from the single-device
    state on cuda:0 for 3 frames at 128^3: each slab lives on its own
    card and K4, K5 and K6 launch there, and pose, volume, planes, model
    vertices and valid mask are bit-identical to the single-device step;
    then the XLA path's first frame on the same mesh integrates as the
    single-device one, bit for bit. Skips with fewer than two cards."""
    from housescan_tpu_torch.kinfu.tsdf import tsdf_integrate
    from housescan_tpu_torch.parallel import make_mesh, sharded_kinfu_init
    from housescan_tpu_torch.parallel.sharded import (
        make_sharded_step,
        sharded_state_from_single,
        single_state_from_sharded,
    )

    n = min(torch.cuda.device_count(), 4)
    if n < 2:
        pytest.skip("needs two or more CUDA devices")
    dev0 = torch.device("cuda", 0)
    poses, frames = _stream(QQVGA, 3, 0.06, dev0)
    mesh = make_mesh(n)
    assert [d.index for d in mesh.devices] == list(range(n))
    step = make_sharded_step(mesh, QQVGA, iterations=(10, 5, 4), use_pallas=True)
    ref = kinfu_init(QQVGA, resolution=128, size_m=3.0, trunc=0.06, init_pose=poses[0],
                     dtype=torch.int32, device=dev0)
    for k in range(3):
        sh_in = sharded_state_from_single(mesh, ref, True)
        assert [s.device for s in sh_in.volume.slabs] == mesh.devices
        sh = single_state_from_sharded(step(sh_in, frames[k]))
        ref = kinfu_step(ref, frames[k], QQVGA)
        for d in mesh.devices:
            torch.cuda.synchronize(d)
        assert torch.equal(sh.pose, ref.pose)
        assert torch.equal(sh.volume.data, ref.volume.data)
        assert torch.equal(sh.planes, ref.planes)
        assert torch.equal(sh.model_maps[mp.MD_V], ref.model_maps[mp.MD_V])
        assert torch.equal(sh.model_maps[mp.MD_VALID], ref.model_maps[mp.MD_VALID])
    xstep = make_sharded_step(mesh, QQVGA, use_pallas=False)
    xs = sharded_kinfu_init(mesh, QQVGA, resolution=64, size_m=3.0, trunc=0.1, init_pose=poses[0])
    xs = xstep(xs, frames[0])
    single = tsdf_integrate(tsdf_new(64, 3.0, 0.1, device=dev0), frames[0],
                            torch.from_numpy(poses[0]).to(dev0), QQVGA)
    assert torch.equal(xs.volume.gather().data, single.data)


@pytest.mark.gpu
def test_tracked_two_room_building_on_card(cuda, tmp_path):
    """Twin of tests/test_building.py's tracked two-room building (542
    tracked frames a room on the XLA path at 64^3; on the CPU the port's
    eager ray marcher takes ~1 s a frame, so the twin runs here): every
    assembly stage engages, with the reference's bounds."""
    import json

    from housescan_tpu_torch.capture.replay import DepthStream
    from housescan_tpu_torch.config import Config, RansacConfig, TsdfConfig
    from housescan_tpu_torch.kinfu.building import RoomScan, scan_building
    from housescan_tpu_torch.kinfu.synthetic import coverage_sweep_poses, flat_furnished_room

    cfg = Config(tsdf=TsdfConfig(resolution=64, size_m=3.2, trunc_dist=0.1),
                 ransac=RansacConfig(min_inlier_fraction=0.005, max_planes=16, n_hypotheses=1024))
    half, boxes = flat_furnished_room()
    poses = coverage_sweep_poses()
    frames = render_depth_stream(QQVGA, poses, half, boxes=boxes, device=cuda).cpu().numpy()
    rooms = [RoomScan(name=f"room{ri}", stream=DepthStream(frames=frames, intrinsics=QQVGA),
                      init_pose=poses[0]) for ri in range(2)]
    scene, fitted, out = scan_building(rooms, tmp_path / "bld", config=cfg, gap=0.1, device=cuda)
    bc = json.loads((out / "building_checkpoint.json").read_text())
    assert set(bc["fit_rmse"]) == {"room0", "room1"}, bc["fit_rmse"]
    for name, rmse in bc["fit_rmse"].items():
        assert rmse < 0.06, f"{name}: cuboid RMSE {rmse * 1000:.1f} mm"
    for r in fitted:
        assert len(r.corners) == 8 and len(r.planes) == 6
        cs = np.stack([c for _, c in r.corners])
        dims = np.sort(cs.max(axis=0) - cs.min(axis=0))
        assert np.allclose(dims, [1.5, 2.6, 2.6], atol=0.1), dims
    assert bc["n_wall_connections"] >= 1 and len(scene.connected_walls) >= 1
    assert bc["optimize"] and any(nc >= 1 for _a, nc, _r in bc["optimize"])
    off = float(fitted[1].mean()[0] - fitted[0].mean()[0])
    assert 2.4 < off < 3.0, f"room1 - room0 X offset {off:.2f} m"


def _sweep_buildings_rooms(n, cuda):
    """tests/test_building.py's full-coverage known-pose sweeps (walls up
    and down, floor and ceiling passes, 6 poses each) of ``n`` rooms."""
    from housescan_tpu_torch.capture.replay import DepthStream
    from housescan_tpu_torch.kinfu.building import RoomScan

    half = np.array([1.3, 1.1, 1.3], np.float32)
    _, boxes = furnished_room()
    rooms = []
    for ri in range(n):
        sweeps = [orbit_poses(6, radius=0.25, yaw_range=6.283, pitch=p, seed=ri)
                  for p in (0.35, -0.35)]
        sweeps.append(orbit_poses(6, radius=0.7, height=-0.6, yaw_range=6.283, pitch=-1.2, seed=ri))
        sweeps.append(orbit_poses(6, radius=0.7, height=0.6, yaw_range=6.283, pitch=1.2, seed=ri))
        poses = np.concatenate(sweeps)
        frames = render_depth_stream(QQVGA, poses, half, boxes, seed=ri, device=cuda).cpu().numpy()
        rooms.append(RoomScan(name=f"room{ri}", stream=DepthStream(frames=frames, intrinsics=QQVGA),
                              init_pose=poses[0], known_poses=poses))
    return rooms


def _grid_config():
    from housescan_tpu_torch.config import Config, RansacConfig, TsdfConfig

    return Config(tsdf=TsdfConfig(resolution=128, size_m=3.2, trunc_dist=0.06),
                  ransac=RansacConfig(min_inlier_fraction=0.01, max_planes=12, n_hypotheses=1024))


@pytest.mark.gpu
def test_eight_room_grid_building_on_card(cuda, tmp_path):
    """Twin of tests/test_building.py's 8-room grid building (on the CPU
    the port's plain versions take ~56 s a room): every grid neighbour
    pair chained on X and Z, room width + gap apart."""
    import json

    from housescan_tpu_torch.kinfu.building import cantor_slots, scan_building

    scene, fitted, out = scan_building(_sweep_buildings_rooms(8, cuda), tmp_path / "bld",
                                       config=_grid_config(), gap=0.1, layout="grid", device=cuda)
    assert len(scene.rooms) == 8
    done = json.loads((out / "building_checkpoint.json").read_text())
    assert done["rooms_done"] == [f"room{i}" for i in range(8)]
    assert len(sorted((out / "xf").glob("*.xf"))) == 8
    assert len(scene.connected_walls) >= 2
    by_slot = {s: i for i, s in enumerate(cantor_slots(8))}
    n_checked = 0
    for (gx, gz), i in by_slot.items():
        for dx, dz, axis_i in ((1, 0, 0), (0, 1, 2)):
            j = by_slot.get((gx + dx, gz + dz))
            if j is not None:
                off = float(fitted[j].mean()[axis_i] - fitted[i].mean()[axis_i])
                assert 2.3 < off < 3.1, f"rooms {i}->{j} axis {axis_i}: offset {off:.2f} m"
                n_checked += 1
    assert n_checked >= 2


@pytest.mark.gpu
def test_three_floor_building_on_card(cuda, tmp_path):
    """Twin of tests/test_building.py's three-floor building: 7 wall
    connections, the Y axis optimised, floors ceiling-to-floor apart."""
    import json

    from housescan_tpu_torch.kinfu.building import cantor_slots_3d, scan_building

    scene, fitted, out = scan_building(_sweep_buildings_rooms(6, cuda), tmp_path / "bld",
                                       config=_grid_config(), gap=0.1, layout="grid", floors=3,
                                       device=cuda)
    bc = json.loads((out / "building_checkpoint.json").read_text())
    assert set(bc["fit_rmse"]) == {f"room{i}" for i in range(6)}
    assert bc["n_wall_connections"] == 7
    assert sum(nc for axis, nc, _ in bc["optimize"] if axis == "Y") >= 4, bc["optimize"]
    by_slot = {s: i for i, s in enumerate(cantor_slots_3d(6, 3))}
    n_checked = 0
    for (gx, fl, gz), i in by_slot.items():
        j = by_slot.get((gx, fl + 1, gz))
        if j is not None:
            off = float(fitted[j].mean()[1] - fitted[i].mean()[1])
            assert -2.7 < off < -1.9, f"floor {fl}->{fl + 1} at ({gx},{gz}): Y offset {off:.2f} m"
            n_checked += 1
        j = by_slot.get((gx + 1, fl, gz))
        if j is not None:
            off = float(fitted[j].mean()[0] - fitted[i].mean()[0])
            assert 2.3 < off < 3.1, f"X offset {off:.2f} m on floor {fl}"
    assert n_checked == 4


def _portbench():
    bench = str(Path(__file__).resolve().parents[1] / "portbench")
    if bench not in sys.path:
        sys.path.append(bench)
    from harness import spec

    return spec


@pytest.mark.gpu
def test_room_scan_at_1024_matches_the_reference(cuda):
    """``scan_to_room_dir`` at room-vga-1024 on 3 frames of the
    room-scan traffic: every frame tracked, and poses, clouds, planes,
    hulls and mesh within the cell's limits of the plain reference."""
    spec = _portbench()
    cell = spec.resolve(spec.load_benchmark(), "room-vga-1024.room-scan")
    t = cell.traffic  # the first 3 frames: the cell's yaw a frame kept
    first3 = dict(t, frames=3, yaw_range_rad=t["yaw_range_rad"] * 3 / t["frames"])
    cell = cell._replace(traffic=first3)
    res = spec.driver("scan").run(cell, 2**31 + 5, 0.0, False, time.time())
    assert res.window.scans == 1 and res.failed == 0
    over = {k: v for k, v in res.numbers.items() if not v <= cell.limits["numbers"][k]}
    assert not over, res.numbers


@pytest.mark.gpu
def test_raycast_kernel_bit_identical_on_the_room_scan_planes(cuda):
    """K6 on the planes of a 1024^3 volume over 6 m (2,097,152 sub-blocks)
    after the room-scan's first 3 frames, fused at their true poses: all 9
    rows bit-identical to the plain version at the last pose."""
    spec = _portbench()
    cell = spec.resolve(spec.load_benchmark(), "room-vga-1024.room-scan")
    drv = spec.driver("scan")
    t = cell.traffic
    first3 = dict(t, frames=3, yaw_range_rad=t["yaw_range_rad"] * 3 / t["frames"])
    inputs = drv.make_inputs(cell.config, first3, 2**31 + 6, cuda)
    vol = tsdf_new(1024, 6.0, 0.03, device=cuda)
    planes = torch.zeros(planes_shape(1024), device=cuda)
    for d, p in zip(inputs.frames, inputs.poses):
        tsdf_integrate_stream(vol, planes, torch.from_numpy(d).to(cuda),
                              torch.from_numpy(p).to(cuda), VGA)
    pose = torch.from_numpy(inputs.poses[-1]).to(cuda)
    cand = build_tile_candidates(planes, pose, VGA, vol)
    params = _ray_params(pose, VGA, 0.3, 5)
    k = launch_raycast_kernel(cand, params, 480, 640)
    q = raycast_tiles_plain(cand, params, 480, 640)
    torch.cuda.synchronize()
    assert torch.equal(k, q)
    assert int((q[0] > 0).sum()) > 20000


@pytest.mark.gpu
def test_house_on_floors_matches_the_reference(cuda):
    """A 6-room house on floors of 3, 2 and 1 (the house-vga-512 cell's
    traffic, 32 known poses a room, at 160 x 120 and 128^3 over 3 m)
    through ``portbench/drivers/building.py`` on the card: every room
    fitted, every replayed room directory (2 a floor) equal to the plain
    reference's, the assembly within the cell's limits, and the grid's 6
    wall connections
    (floor 0: 1 on X and 1 on Z; floor 1: 1 on X; 3 ceilings under a
    floor)."""
    spec = _portbench()
    cell = spec.resolve(spec.load_benchmark(), "house-vga-512.building")
    qqvga = dict(width=160, height=120, fx=131.25, fy=131.25, cx=79.5, cy=59.5)
    cfg = dict(cell.config, camera=dict(cell.config["camera"], **qqvga),
               volume=dict(cell.config["volume"], resolution=128),
               building=dict(cell.config["building"], rooms=6, floors=[3, 2, 1]))
    cell = cell._replace(config=cfg, traffic=dict(cell.traffic, rooms=6, floors="3,2,1"))
    res = spec.driver("building").run(cell, 2**31 + 7, 0.0, False, time.time())
    assert res.failed == 0 and res.notes["unfitted"] == []
    assert all(res.numbers[k] == 0.0 for k in ("cloud_gap_mm", "cloud_count_gap", "plane_gap",
                                               "hull_gap_mm")), res.numbers
    over = {k: v for k, v in res.numbers.items() if not v <= cell.limits["numbers"][k]}
    assert not over, res.numbers
    axes = sorted(ax for _, _, ax in res.window.got.connections)
    assert axes == [0, 0, 1, 1, 1, 2], res.window.got.connections


@pytest.mark.gpu
def test_full_room_export_keeps_its_far_wall(cuda, tmp_path):
    """A room of the house cell at its widest stretch (1.05: 2.73 x 2.2 x
    2.73 m) fused from its 32 known poses at kinect-vga-512's settings has
    more surface voxels than 1 << 20, the reference package's cap, which
    kept the first in raster order and so lost the +x wall; the export
    keeps every one, and the room stage finds the room's 8 corners."""
    from housescan_tpu_torch.capture.replay import DepthStream
    from housescan_tpu_torch.config import Config
    from housescan_tpu_torch.kinfu.scan import scan_to_room_dir
    from housescan_tpu_torch.rooms import Scene, adopt_bbox_corners, load_room, suggest_corners

    spec = _portbench()
    cell = spec.resolve(spec.load_benchmark(), "house-vga-512.building")
    drv = spec.driver("building")
    poses = drv.room_poses(cell.traffic)
    half, boxes = furnished_room()
    half, boxes = half.copy(), boxes.copy()
    half[[0, 2]] *= 1.05
    boxes[:, :, [0, 2]] *= 1.05
    mm = drv._scan.depth_stream_mm(cell.config["camera"], poses, half, boxes, 0.002, 2**31 + 8,
                                   cuda)
    frames = mm.cpu().numpy().astype(np.float32) * 0.001
    room = scan_to_room_dir(DepthStream(frames, VGA, poses), tmp_path / "room", Config(),
                            init_pose=poses[0], known_poses=poses, device=cuda)
    from reference import scan as ref_scan

    cloud = ref_scan.read_pcd(room / "cloud_bin.pcd")
    assert len(cloud) > 1 << 20 and float(cloud[:, 0].max()) > 1.3
    scene = Scene(device="cpu")
    loaded = adopt_bbox_corners(scene, suggest_corners(scene, load_room(scene, room)))
    assert len(loaded.corners) == 8


@pytest.mark.gpu
def test_known_pose_step_and_fit_objective_wait_on_nothing(cuda):
    """Under PyTorch's sync debug mode, a known-pose step (its pose a host
    array, as ``scan-building --known-poses`` hands it) and the cuboid
    fit's objective on a batch of corner sets make the host wait on the
    card nowhere; the step takes the known pose as it is."""
    from housescan_tpu_torch.solvers.cuboid_fit import errfun_closest

    poses, frames = _stream(QQVGA, 3, np.pi / 64, cuda)
    st = kinfu_init(QQVGA, resolution=128, size_m=3.0, trunc=0.06, init_pose=poses[0],
                    device=cuda)
    for k in range(2):
        st = kinfu_step(st, frames[k], QQVGA, forced_pose=poses[k])
    pts = torch.rand(4, 8, 3, device=cuda)
    params = torch.rand(4, 12, 10, device=cuda) + 0.5
    errfun_closest(pts[:, None], params)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        st = kinfu_step(st, frames[2], QQVGA, forced_pose=poses[2])
        f = errfun_closest(pts[:, None], params)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert f.shape == (4, 12) and bool(torch.isfinite(f).all())
    np.testing.assert_array_equal(st.pose.cpu().numpy(), np.asarray(poses[2], np.float32))
