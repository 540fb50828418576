"""Channel-major (C, H, W) map layouts of the tracking path.

Row layouts (all float32):

  * live maps (6, h, w):  0-2 vertex xyz (camera frame),
                          3-5 normal xyz (camera frame, 0 = invalid)
  * model maps (8, h, w): 0 depth (projective, 0 = invalid),
                          1-3 vertex xyz (world), 4-6 normal xyz (world),
                          7 valid (1.0 / 0.0)
  * ICP packed (19, h, w): rows 0-5 live v+n, 6-8 model v, 9-11 model n,
                          12 valid, 13-15 du-gradient, 16-18 dv-gradient

Downsampling is exact point sampling (level pixel (i, j) = fine pixel
(2i, 2j)); on the GPU that is a strided slice.
"""

from __future__ import annotations

from typing import List

import torch
import torch.nn.functional as F

MD_DEPTH = 0
MD_V = slice(1, 4)
MD_N = slice(4, 7)
MD_VALID = 7
MODEL_ROWS = 8

LV_V = slice(0, 3)
LV_N = slice(3, 6)
LIVE_ROWS = 6


def halve_maps(m: torch.Tensor) -> torch.Tensor:
    """(C, h, w) -> (C, h//2, w//2): pixel (2i, 2j). Slices to floor(n/2)
    so odd sizes match the reference."""
    _, h, w = m.shape
    return m[:, : 2 * (h // 2) : 2, : 2 * (w // 2) : 2]


def build_map_pyramid(maps: torch.Tensor, levels: int) -> List[torch.Tensor]:
    """[(C, h, w), (C, h/2, w/2), ...] — level 0 first (finest)."""
    out = [maps]
    for _ in range(1, levels):
        out.append(halve_maps(out[-1]))
    return out


def model_gradients(model: torch.Tensor) -> torch.Tensor:
    """(8, h, w) model maps -> (6, h, w) central-difference vertex
    gradients (rows 0-2 along +u, 3-5 along +v), zero where a stencil
    neighbour is invalid. Neighbours wrap around, as the reference's roll."""
    v = model[MD_V]
    ok = model[MD_VALID] > 0.5

    def sh(m, dy, dx):
        return torch.roll(m, (-dy, -dx), (-2, -1))

    ok_u = sh(ok, 0, 1) & sh(ok, 0, -1)
    ok_v = sh(ok, 1, 0) & sh(ok, -1, 0)
    zero = torch.zeros_like(v)
    gu = torch.where(ok_u[None], 0.5 * (sh(v, 0, 1) - sh(v, 0, -1)), zero)
    gv = torch.where(ok_v[None], 0.5 * (sh(v, 1, 0) - sh(v, -1, 0)), zero)
    return torch.cat([gu, gv], dim=0)


def pack_icp_inputs(
    live: torch.Tensor,
    model: torch.Tensor,
    grads: torch.Tensor,
    band_h: int,
    lane: int = 128,
) -> torch.Tensor:
    """(19, hp, wp) zero-padded ICP kernel input (``ops/icp_cuda.py``)."""
    packed = torch.cat([live, model[1:MODEL_ROWS], grads], dim=0)
    _, h, w = packed.shape
    hp = -(-h // band_h) * band_h
    wp = -(-w // lane) * lane
    if (hp, wp) != (h, w):
        packed = F.pad(packed, (0, wp - w, 0, hp - h))
    return packed.contiguous()


# ---- interleaved (h, w, 3) maps of the XLA path (``kinfu/icp.py``,
# ``kinfu/raycast.py``) ------------------------------------------------


def model_to_hwc(model: torch.Tensor):
    """(8, h, w) model maps -> (vertices (h, w, 3), normals (h, w, 3),
    valid (h, w) bool, depth (h, w))."""
    return (model[MD_V].permute(1, 2, 0), model[MD_N].permute(1, 2, 0),
            model[MD_VALID] > 0.5, model[MD_DEPTH])


def model_from_hwc(vertices, normals, valid, depth) -> torch.Tensor:
    """Inverse of ``model_to_hwc``."""
    return torch.cat([
        depth[None].to(torch.float32),
        vertices.permute(2, 0, 1),
        normals.permute(2, 0, 1),
        valid[None].to(torch.float32),
    ], dim=0)


def live_to_hwc(live: torch.Tensor):
    """(6, h, w) live maps -> (vertices (h, w, 3), normals (h, w, 3))."""
    return live[LV_V].permute(1, 2, 0), live[LV_N].permute(1, 2, 0)


def live_from_hwc(vertices, normals) -> torch.Tensor:
    return torch.cat([vertices.permute(2, 0, 1), normals.permute(2, 0, 1)], dim=0)
