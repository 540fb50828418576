"""Rigid transforms in the row-vector convention of ``housescan_tpu``.

Points are ROW vectors and transforms right-multiply, ``p' = p @ M``. A
4x4 rigid transform stores the rotation in ``M[:3, :3]`` and the
translation in the last row ``M[3, :3]``.

Only what the fusion step uses is ported: ``mm``, ``axis_angle_mat``,
``apply_proj4``, ``compose_proj4`` and ``inverse_rigid``.
"""

from __future__ import annotations

import torch


def full_fp32_matmul() -> None:
    """Pin float32 matmuls and convolutions to full precision on CUDA.

    TF32 keeps ~10 mantissa bits; geometry transforms and the ICP
    reduction need all 24 (a reduced-precision pose path measured an
    order of magnitude more pose error in the reference)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Matmul at full float32 precision once ``full_fp32_matmul`` ran
    (``kinfu_init`` calls it for a CUDA device)."""
    return torch.matmul(a, b)


def axis_angle_mat(axis: torch.Tensor, theta) -> torch.Tensor:
    """Row-vector rotation matrix for rotation by ``theta`` about ``axis``
    (Rodrigues' formula, transposed for row vectors)."""
    axis = torch.as_tensor(axis)
    theta = torch.as_tensor(theta, dtype=axis.dtype, device=axis.device)
    n = torch.linalg.norm(axis, dim=-1, keepdim=True)
    u = axis / torch.clamp(n, min=torch.finfo(axis.dtype).tiny)
    x, y, z = u[..., 0], u[..., 1], u[..., 2]
    c, s = torch.cos(theta), torch.sin(theta)
    one_c = 1.0 - c
    r = torch.stack(
        [
            torch.stack([c + x * x * one_c, x * y * one_c - z * s, x * z * one_c + y * s], -1),
            torch.stack([y * x * one_c + z * s, c + y * y * one_c, y * z * one_c - x * s], -1),
            torch.stack([z * x * one_c - y * s, z * y * one_c + x * s, c + z * z * one_c], -1),
        ],
        dim=-2,
    )
    return r.transpose(-1, -2)


def compose_proj4(first: torch.Tensor, then: torch.Tensor) -> torch.Tensor:
    """Apply ``first`` then ``then``: ``first @ then`` for row vectors."""
    return mm(first, then)


def apply_proj4(proj: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    """Apply a 4x4 row-vector rigid transform to (..., 3) points."""
    return mm(points, proj[:3, :3]) + proj[3, :3]


def inverse_rigid(m: torch.Tensor) -> torch.Tensor:
    """Inverse of a rigid row-vector 4x4: R -> R^T, t -> -t R^T."""
    r = m[:3, :3]
    t = m[3, :3]
    inv = torch.eye(4, dtype=m.dtype, device=m.device)
    inv[:3, :3] = r.T
    inv[3, :3] = mm(-t, r.T)
    return inv
