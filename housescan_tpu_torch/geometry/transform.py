"""Rigid transforms in the row-vector convention of ``housescan_tpu``.

Points are ROW vectors and transforms right-multiply, ``p' = p @ M``. A
4x4 rigid transform stores the rotation in ``M[:3, :3]`` and the
translation in the last row ``M[3, :3]``.

A port of ``housescan_tpu/geometry/transform.py`` (plus
``inverse_rigid``, which the fusion step uses). Every function computes on
the device of its tensor arguments; ``on_device`` is how an entry point
turns its ``device`` argument into a device, with TF32 off on the card.
"""

from __future__ import annotations

import numpy as np
import torch


def full_fp32_matmul() -> None:
    """Pin float32 matmuls and convolutions to full precision on CUDA.

    TF32 keeps ~10 mantissa bits; geometry transforms and the ICP
    reduction need all 24 (a reduced-precision pose path measured an
    order of magnitude more pose error in the reference)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def on_device(device) -> torch.device:
    """``device`` as a ``torch.device``; for a CUDA device, float32
    matmuls are pinned to full precision first (``full_fp32_matmul``)."""
    device = torch.device(device)
    if device.type == "cuda":
        full_fp32_matmul()
    return device


def f32(x, device) -> torch.Tensor:
    """``x`` (a host array, a scalar or a tensor) as a float32 tensor on
    ``device``; a host array is copied. Under JAX's default (x64 off)
    ``jnp.asarray`` of a float64 array gives float32, where
    ``torch.as_tensor`` would keep float64 and compute a different, more
    precise thing: every host value the room stage and the solvers send
    to the device goes through here."""
    device = on_device(device)
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.float32)
    return torch.tensor(np.asarray(x, dtype=np.float32), device=device)


def mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Matmul at full float32 precision once ``full_fp32_matmul`` ran
    (``kinfu_init`` calls it for a CUDA device)."""
    return torch.matmul(a, b)


def normalize(v: torch.Tensor, eps: float = 0.0) -> torch.Tensor:
    """Unit vector along ``v`` (last axis)."""
    n = torch.linalg.norm(v, dim=-1, keepdim=True)
    if eps:
        n = torch.clamp(n, min=eps)
    return v / n


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


def quat_rot_mat(q: torch.Tensor) -> torch.Tensor:
    """Row-vector rotation matrix of the quaternion ``(x, y, z, w)``,
    normalized first, so any nonzero 4-vector is a rotation (what the
    cuboid fit optimizes over)."""
    q = q / torch.linalg.norm(q, dim=-1, keepdim=True)
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    r = torch.stack(
        [
            torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)], -1),
            torch.stack([2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)], -1),
            torch.stack([2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)], -1),
        ],
        dim=-2,
    )
    return r.transpose(-1, -2)


def rotate_around(rot_center: torch.Tensor, rot_mat: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    """Rotate point(s) around ``rot_center``: ``(p - c) @ M + c``."""
    return mm(points - rot_center, rot_mat) + rot_center


def rotation_between_normals(n1: torch.Tensor, n2: torch.Tensor) -> torch.Tensor:
    """Rotation matrix turning direction ``n1`` into direction ``n2``:
    about n1 x n2 by acos of their cosine. Parallel inputs give the
    identity; anti-parallel ones turn 180 degrees about a perpendicular
    of n1 (the cross product vanishes there)."""
    axis = torch.linalg.cross(n1, n2)
    cos_theta = torch.dot(n1, n2) / (torch.linalg.norm(n1) * torch.linalg.norm(n2))
    theta = torch.arccos(torch.clamp(cos_theta, -1.0, 1.0))
    e0 = torch.tensor([1.0, 0.0, 0.0], dtype=n1.dtype, device=n1.device)
    e1 = torch.tensor([0.0, 1.0, 0.0], dtype=n1.dtype, device=n1.device)
    fallback = torch.linalg.cross(n1, torch.where(n1[0].abs() < 0.9, e0, e1))
    axis = torch.where(torch.linalg.norm(axis) < 1e-12, fallback, axis)
    return axis_angle_mat(axis, theta)


# --- 4x4 transforms (row-vector convention, translation in the last row) ---


def identity_proj4(dtype=torch.float32, device="cuda") -> torch.Tensor:
    return torch.eye(4, dtype=dtype, device=on_device(device))


def proj4_from_rot(rot_mat: torch.Tensor) -> torch.Tensor:
    m = torch.eye(4, dtype=rot_mat.dtype, device=rot_mat.device)
    m[:3, :3] = rot_mat
    return m


def proj4_from_translation(offset: torch.Tensor) -> torch.Tensor:
    m = torch.eye(4, dtype=offset.dtype, device=offset.device)
    m[3, :3] = offset
    return m


def rotation_proj4_around(rot_center: torch.Tensor, rot_mat: torch.Tensor) -> torch.Tensor:
    """4x4 of the rotation about ``rot_center``: T(-c) R T(c)."""
    return mm(mm(proj4_from_translation(-rot_center), proj4_from_rot(rot_mat)),
              proj4_from_translation(rot_center))


def transpose_for_export(proj: torch.Tensor) -> torch.Tensor:
    """The column-vector (left-multiplicative) form external tools such
    as plyxform expect: the transpose."""
    return proj.T


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
