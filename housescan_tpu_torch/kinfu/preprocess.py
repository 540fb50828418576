"""Depth-frame preprocessing: bilateral filter, pyramid, vertex/normal maps.

Invalid depth is 0; invalid vertices/normals are zeros. Live maps are
channel-major (6, h, w): rows 0-2 camera-frame vertices, rows 3-5
normals (``kinfu/maps.py``).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from housescan_tpu_torch.kinfu.camera import Intrinsics, pixel_rays
from housescan_tpu_torch.ops.preprocess_cuda import bilateral_filter_cuda
from housescan_tpu_torch.ops.preprocess_cuda import (  # noqa: F401  K1's plain version
    bilateral_filter_plain as bilateral_filter,
)
from housescan_tpu_torch.ops.pyramid_cuda import (  # noqa: F401  parts of K11's plain version
    _normals_cm,
    downsample_depth,
    pyramid_cuda,
)


def depth_to_vertices(depth: torch.Tensor, intr: Intrinsics) -> torch.Tensor:
    """(H, W) depth -> (H, W, 3) camera-frame vertex map (0 where invalid)."""
    return pixel_rays(intr, depth.dtype, device=depth.device) * depth[..., None]


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
    """Bilateral filter (K1) then the coarser depths and per-level packed
    live maps (K11; both take their plain versions for a CPU tensor)."""
    d0 = bilateral_filter_cuda(raw_depth, bilateral_radius, sigma_space, sigma_depth)
    return FramePyramid(*pyramid_cuda(d0, intr, levels, sigma_depth))
