"""Pinhole camera model.

Conventions: camera x right, y down, z forward; pixel (u, v) with u
along the width; ``u = fx * x / z + cx``. Poses are 4x4 row-vector
camera-to-world transforms (``p_world = p_cam @ R + t``).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch


class Intrinsics(NamedTuple):
    """Static pinhole intrinsics (hashable)."""

    width: int
    height: int
    fx: float
    fy: float
    cx: float
    cy: float

    def level(self, lvl: int) -> "Intrinsics":
        """Intrinsics of pyramid level ``lvl`` in the POINT-SAMPLING
        convention: level pixel (i, j) sits on fine pixel (2^l i, 2^l j),
        so cx scales as cx / 2^l."""
        f = 1 << lvl
        return Intrinsics(
            self.width // f,
            self.height // f,
            self.fx / f,
            self.fy / f,
            self.cx / f,
            self.cy / f,
        )


def pixel_rays(intr: Intrinsics, dtype=torch.float32, *, device=None) -> torch.Tensor:
    """(H, W, 3) camera-frame ray directions with z = 1."""
    u = torch.arange(intr.width, dtype=dtype, device=device)
    v = torch.arange(intr.height, dtype=dtype, device=device)
    x = ((u[None, :] - intr.cx) / intr.fx).expand(intr.height, intr.width)
    y = ((v[:, None] - intr.cy) / intr.fy).expand(intr.height, intr.width)
    return torch.stack([x, y, torch.ones_like(x)], dim=-1)


def project(
    intr: Intrinsics, points_cam: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Camera-frame points (..., 3) -> (u, v, valid-in-front)."""
    z = points_cam[..., 2]
    safe_z = torch.where(z > 1e-6, z, torch.ones_like(z))
    u = intr.fx * points_cam[..., 0] / safe_z + intr.cx
    v = intr.fy * points_cam[..., 1] / safe_z + intr.cy
    return u, v, z > 1e-6


def in_bounds(intr: Intrinsics, u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return (u >= 0) & (u <= intr.width - 1) & (v >= 0) & (v <= intr.height - 1)
