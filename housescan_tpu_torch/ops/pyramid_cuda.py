"""K11: the tracker's live pyramid after the bilateral filter.

From K1's filtered ``(H, W)`` depth: the coarser depths (a discontinuity-
gated 3x3 smooth, point-sampled at the even pixels) and each level's
``(6, h, w)`` live maps (camera-frame vertex rows, then unit normal rows
by central differences). The reference has no kernel here: its pyramid is
XLA array code (``housescan_tpu/kinfu/preprocess.py:228``). The plain
version below is that code in PyTorch, about 450 small tensor operations
at three levels (two 9-tap downsamples, four ``torch.roll`` and ~45
elementwise operations a level's normals), whose host dispatch was the
largest block of the tracked step's.

CUDA kernel ``csrc/pyramid.cu``: one launch a level, all from one ctypes
call on the current stream; launch l writes level l's maps and depth
l + 1 from two ranges of one grid. At 640x480 it reads 1.2 MB and writes
10.1 MB: its bound by bytes is 0.0034 ms. Each value repeats the plain
version's float32 operations in their order as PyTorch runs them on the
card (a tensor divided by a Python float is a multiply by the float32
reciprocal; the normals' neighbours wrap around, the downsample's are
zero-filled), so under ``--fmad=false`` the kernel is bit-identical to
``pyramid_plain`` on the card, ``-0.0`` included.

CUDA C++ rather than Triton: the route and build of K1, whose output it
reads, and ``--fmad=false``, which the bit-identity needs.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from housescan_tpu_torch.kinfu.camera import Intrinsics
from housescan_tpu_torch.kinfu.maps import halve_maps
from housescan_tpu_torch.ops import cuda_lib
from housescan_tpu_torch.ops.preprocess_cuda import _shift2d

ALIGN = 64  # floats: every output of the kernel starts on a 256-byte boundary
MAX_DEPTH_JUMP = 0.08  # m: the normals' continuity gate


def downsample_depth(depth: torch.Tensor, sigma_depth: float = 0.03) -> torch.Tensor:
    """Halve resolution in the POINT-SAMPLING convention: a discontinuity-
    gated 3x3 smooth centered on fine pixel (2i, 2j), then [::2, ::2]."""
    center = depth
    weight_sum = torch.zeros_like(depth)
    value_sum = torch.zeros_like(depth)
    zero = torch.zeros_like(depth)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            s = _shift2d(depth, dy, dx)
            w = 1.0 if (dy == 0 and dx == 0) else 0.5
            ok = (s > 0) & ((s - center).abs() < 3 * sigma_depth)
            wv = torch.where(ok, w, zero)
            weight_sum = weight_sum + wv
            value_sum = value_sum + wv * s
    smoothed = torch.where(
        (center > 0) & (weight_sum > 0),
        value_sum / torch.clamp(weight_sum, min=1e-12),
        zero,
    )
    return halve_maps(smoothed[None])[0]


def _vertices_cm(depth: torch.Tensor, intr: Intrinsics) -> torch.Tensor:
    """(h, w) depth -> (3, h, w) camera-frame vertex rows."""
    h, w = depth.shape
    cols = torch.arange(w, dtype=depth.dtype, device=depth.device)[None, :]
    rows = torch.arange(h, dtype=depth.dtype, device=depth.device)[:, None]
    vx = (cols - intr.cx) / intr.fx * depth
    vy = (rows - intr.cy) / intr.fy * depth
    return torch.stack([vx, vy, depth], dim=0)


def _normals_cm(v: torch.Tensor, max_depth_jump: float = MAX_DEPTH_JUMP) -> torch.Tensor:
    """(3, h, w) vertex rows -> (3, h, w) unit normals by central
    differences (wrap-around neighbours, as the reference's roll), oriented
    toward the camera; zero where a neighbour is missing, the depth jumps
    by more than ``max_depth_jump`` or the cross product degenerates."""
    vr = torch.roll(v, -1, dims=2)
    vl = torch.roll(v, 1, dims=2)
    vd = torch.roll(v, -1, dims=1)
    vu = torch.roll(v, 1, dims=1)
    du = vr - vl
    dv = vd - vu
    nx = dv[1] * du[2] - dv[2] * du[1]
    ny = dv[2] * du[0] - dv[0] * du[2]
    nz = dv[0] * du[1] - dv[1] * du[0]
    n = torch.stack([nx, ny, nz], dim=0)
    norm = torch.sqrt(nx * nx + ny * ny + nz * nz)
    z = v[2]
    continuous = (
        ((vr[2] - z).abs() < max_depth_jump)
        & ((vl[2] - z).abs() < max_depth_jump)
        & ((vd[2] - z).abs() < max_depth_jump)
        & ((vu[2] - z).abs() < max_depth_jump)
    )
    valid = (
        (z > 0)
        & (vr[2] > 0)
        & (vl[2] > 0)
        & (vd[2] > 0)
        & (vu[2] > 0)
        & continuous
        & (norm > 1e-12)
    )
    n = n / torch.clamp(norm, min=1e-12)[None]
    flip = (n[0] * v[0] + n[1] * v[1] + n[2] * v[2]) > 0
    n = torch.where(flip[None], -n, n)
    return torch.where(valid[None], n, torch.zeros_like(n))


def pyramid_plain(
    d0: torch.Tensor, intr: Intrinsics, levels: int = 3, sigma_depth: float = 0.03
) -> Tuple[Tuple[torch.Tensor, ...], Tuple[torch.Tensor, ...]]:
    """K11's plain version: (depths, maps) of ``levels`` levels from the
    filtered depth ``d0`` (``depths[0]`` is ``d0``)."""
    depths = [d0]
    for _ in range(1, levels):
        depths.append(downsample_depth(depths[-1], sigma_depth))
    maps = []
    for lvl, d in enumerate(depths):
        v = _vertices_cm(d, intr.level(lvl))
        maps.append(torch.cat([v, _normals_cm(v)], dim=0))
    return tuple(depths), tuple(maps)


def pyramid_cuda(
    d0: torch.Tensor, intr: Intrinsics, levels: int = 3, sigma_depth: float = 0.03
) -> Tuple[Tuple[torch.Tensor, ...], Tuple[torch.Tensor, ...]]:
    """K11: the plain version for a CPU tensor, the CUDA kernel otherwise.
    The outputs are views of one new buffer."""
    if d0.device.type == "cpu":
        cuda_lib.plain_counts["pyramid"] += 1
        return pyramid_plain(d0, intr, levels, sigma_depth)
    cuda_lib.require_cuda("pyramid_cuda", d0)
    if d0.dim() != 2 or not 1 <= levels <= 16:
        raise ValueError("pyramid_cuda: (H, W) depth and 1 <= levels <= 16")
    h, w = d0.shape
    shapes = [(h >> lvl, w >> lvl) for lvl in range(levels)]
    # one buffer: depths 1 .. levels-1, then each level's maps
    outs = [((hl, wl), (wl, 1)) for hl, wl in shapes[1:]]
    outs += [((6, hl, wl), (hl * wl, wl, 1)) for hl, wl in shapes]
    offsets, total = [], 0
    for size, stride in outs:
        offsets.append(total)
        total += -(-size[0] * stride[0] // ALIGN) * ALIGN
    buf = torch.empty(total, dtype=torch.float32, device=d0.device)
    views = [buf.as_strided(size, stride, o) for (size, stride), o in zip(outs, offsets)]
    depths, maps = [d0] + views[:levels - 1], views[levels - 1:]
    ptrs = ctypes.c_void_p * levels
    cuda_lib.launch(
        "hs_pyramid", d0.device,
        ptrs(*(d.data_ptr() for d in depths)), ptrs(*(m.data_ptr() for m in maps)),
        levels, h, w, intr.fx, intr.fy, intr.cx, intr.cy, sigma_depth, MAX_DEPTH_JUMP,
    )
    cuda_lib.launch_counts["pyramid"] += 1
    return tuple(depths), tuple(maps)
