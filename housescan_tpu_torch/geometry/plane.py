"""Plane algebra in Hessian normal form ``n . x = d``.

``normal`` has shape (..., 3) (unit length) and ``d`` shape (...,), so
every operation is batched: a room's six walls are one PlaneEq with a
leading dimension of 6. A port of ``housescan_tpu/geometry/plane.py``.
``d`` is on the right-hand side, so the normal's direction matters (rooms
keep inward normals); PCL's ``ax + by + cz + d = 0`` converts by negating
d. Every function computes on the device of its arguments.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from housescan_tpu_torch.geometry.transform import mm


class PlaneEq(NamedTuple):
    """Hessian-normal-form plane(s): ``normal . x = d`` with unit normal."""

    normal: torch.Tensor  # (..., 3)
    d: torch.Tensor  # (...,)


def mk_plane_eq(abc: torch.Tensor, d) -> PlaneEq:
    """Normalize ``abc . x = d`` into Hessian form."""
    abc = torch.as_tensor(abc)
    d = torch.as_tensor(d, dtype=abc.dtype, device=abc.device)
    norm = torch.linalg.norm(abc, dim=-1)
    return PlaneEq(abc / norm[..., None], d / norm)


def mk_plane_eq_abcd(a, b, c, d) -> PlaneEq:
    """From the four coefficients of ``ax + by + cz = d``."""
    abc = torch.stack([torch.as_tensor(a), torch.as_tensor(b), torch.as_tensor(c)], dim=-1)
    return mk_plane_eq(abc, d)


def flip_plane_eq(eq: PlaneEq) -> PlaneEq:
    """The same plane, facing the other way."""
    return PlaneEq(-eq.normal, -eq.d)


def signed_distance_to_plane(eq: PlaneEq, points: torch.Tensor) -> torch.Tensor:
    """``n . p - d``, positive on the normal's side; broadcasts planes
    (..., 3) against points (..., 3)."""
    return (eq.normal * points).sum(dim=-1) - eq.d


def signed_distances_pairwise(eq: PlaneEq, points: torch.Tensor) -> torch.Tensor:
    """(K, N) signed distances of N points to K planes, one matmul."""
    if eq.normal.dim() == 1:
        return mm(points, eq.normal) - eq.d
    return mm(eq.normal, points.T) - eq.d[..., None]


def project_to_plane(eq: PlaneEq, points: torch.Tensor) -> torch.Tensor:
    """Orthogonal projection of points onto the plane."""
    return points - signed_distance_to_plane(eq, points)[..., None] * eq.normal


def rotate_plane_eq(eq: PlaneEq, rot_mat: torch.Tensor) -> PlaneEq:
    """Rotate about the origin: the normal turns, d stays."""
    return PlaneEq(mm(eq.normal, rot_mat), eq.d)


def rotate_plane_eq_around(eq: PlaneEq, rot_center: torch.Tensor, rot_mat: torch.Tensor) -> PlaneEq:
    """Rotate about ``rot_center``: the plane's point nearest the origin,
    ``d n``, turns about the center, and the new d is its projection on
    the new normal."""
    n2 = mm(eq.normal, rot_mat)
    o2 = mm(eq.d[..., None] * eq.normal - rot_center, rot_mat) + rot_center
    return PlaneEq(n2, (o2 * n2).sum(dim=-1))


def translate_plane_eq(eq: PlaneEq, offset: torch.Tensor) -> PlaneEq:
    """Translate by ``offset``: d' = (d n + offset) . n."""
    o2 = eq.d[..., None] * eq.normal + offset
    return PlaneEq(eq.normal, (o2 * eq.normal).sum(dim=-1))


def transform_plane_eq(eq: PlaneEq, proj: torch.Tensor) -> PlaneEq:
    """Apply a rigid row-vector 4x4: rotate about the origin, then
    translate."""
    return translate_plane_eq(rotate_plane_eq(eq, proj[:3, :3]), proj[3, :3])
