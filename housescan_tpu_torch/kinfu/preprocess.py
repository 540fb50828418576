"""Depth-frame preprocessing: bilateral filter, pyramid, vertex/normal maps.

Invalid depth is 0; invalid vertices/normals are zeros. Live maps are
channel-major (6, h, w): rows 0-2 camera-frame vertices, rows 3-5
normals (``kinfu/maps.py``).
"""

from __future__ import annotations

from typing import List, NamedTuple, Tuple

import torch

from housescan_tpu_torch.kinfu.camera import Intrinsics, pixel_rays
from housescan_tpu_torch.kinfu.maps import halve_maps
from housescan_tpu_torch.ops.preprocess_cuda import (
    _shift2d,
    bilateral_filter_cuda,
)
from housescan_tpu_torch.ops.preprocess_cuda import (  # noqa: F401  K1's plain version
    bilateral_filter_plain as bilateral_filter,
)


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


def depth_to_vertices(depth: torch.Tensor, intr: Intrinsics) -> torch.Tensor:
    """(H, W) depth -> (H, W, 3) camera-frame vertex map (0 where invalid)."""
    return pixel_rays(intr, depth.dtype, device=depth.device) * depth[..., None]


def _vertices_cm(depth: torch.Tensor, intr: Intrinsics) -> torch.Tensor:
    """(h, w) depth -> (3, h, w) camera-frame vertex rows."""
    h, w = depth.shape
    cols = torch.arange(w, dtype=depth.dtype, device=depth.device)[None, :]
    rows = torch.arange(h, dtype=depth.dtype, device=depth.device)[:, None]
    vx = (cols - intr.cx) / intr.fx * depth
    vy = (rows - intr.cy) / intr.fy * depth
    return torch.stack([vx, vy, depth], dim=0)


def _normals_cm(v: torch.Tensor, max_depth_jump: float = 0.08) -> torch.Tensor:
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


def vertex_normals(vertices: torch.Tensor, max_depth_jump: float = 0.08) -> torch.Tensor:
    """(H, W, 3) vertex map -> (H, W, 3) unit normals: ``_normals_cm`` on
    the channel-major view (the reference documents its two layouts as
    bit-identical, the math being elementwise per pixel)."""
    return _normals_cm(vertices.permute(2, 0, 1), max_depth_jump).permute(1, 2, 0)


class FramePyramid(NamedTuple):
    """Per-level depth + packed (6, h, w) live maps, level 0 = full res."""

    depths: Tuple[torch.Tensor, ...]
    maps: Tuple[torch.Tensor, ...]


def build_pyramid(
    raw_depth: torch.Tensor,
    intr: Intrinsics,
    levels: int = 3,
    bilateral_radius: int = 3,
    sigma_space: float = 4.5,
    sigma_depth: float = 0.03,
) -> FramePyramid:
    """Bilateral filter (K1) then per-level packed live maps."""
    d0 = bilateral_filter_cuda(raw_depth, bilateral_radius, sigma_space, sigma_depth)
    depths: List[torch.Tensor] = [d0]
    for _ in range(1, levels):
        depths.append(downsample_depth(depths[-1], sigma_depth))
    maps = []
    for lvl, d in enumerate(depths):
        v = _vertices_cm(d, intr.level(lvl))
        maps.append(torch.cat([v, _normals_cm(v)], dim=0))
    return FramePyramid(tuple(depths), tuple(maps))
