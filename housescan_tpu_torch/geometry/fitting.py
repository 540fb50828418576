"""Plane fitting and plane-triple intersection: a port of
``housescan_tpu/geometry/fitting.py``.

Total least squares: the normal is the eigenvector of the 3x3 (weighted)
scatter matrix with the smallest eigenvalue (``torch.linalg.eigh`` sorts
ascending, as ``jnp.linalg.eigh``), and d places the plane through the
(weighted) centroid. float32 throughout; on the card the matmuls need
TF32 off (``geometry/transform.full_fp32_matmul``), which every entry
point sets.

A corner is the solution of ``N x = d`` for three stacked normals. A
near-singular N (|det| <= 1/cond_limit: near-parallel planes) is flagged
invalid and its corner is NaN; the identity is swapped in before the
solve, as the reference does, because ``torch.linalg.solve`` raises on a
singular matrix where ``jnp.linalg.solve`` returns NaNs.
"""

from __future__ import annotations

from typing import Tuple

import torch

from housescan_tpu_torch.geometry.plane import PlaneEq, signed_distance_to_plane
from housescan_tpu_torch.geometry.transform import mm


def fit_plane(points: torch.Tensor) -> PlaneEq:
    """Best-fit plane through (N >= 3, 3) points; the sign is fixed so
    that d >= 0 (callers that need inward normals flip it)."""
    mean = points.mean(dim=0)
    centered = points - mean
    _, eigvecs = torch.linalg.eigh(mm(centered.T, centered))
    normal = eigvecs[:, 0]
    d = torch.dot(normal, mean)
    sign = torch.where(d < 0, -1.0, 1.0).to(points.dtype)
    return PlaneEq(normal * sign, d * sign)


def fit_plane_weighted(points: torch.Tensor, weights: torch.Tensor) -> PlaneEq:
    """Best-fit plane of (N, 3) points with (N,) weights (RANSAC's
    refinement passes its inlier mask). The eigenvector's sign is
    ambiguous; it is fixed so that d >= 0."""
    w = weights[:, None]
    total = torch.clamp(weights.sum(), min=1e-12)
    mean = (points * w).sum(dim=0) / total
    centered = (points - mean) * torch.sqrt(w)
    scatter = mm(centered.T, centered)
    _, eigvecs = torch.linalg.eigh(scatter)
    normal = eigvecs[:, 0]
    d = torch.dot(normal, mean)
    sign = torch.where(d < 0, -1.0, 1.0).to(points.dtype)
    return PlaneEq(normal * sign, d * sign)


def plane_corner(
    eq1: PlaneEq, eq2: PlaneEq, eq3: PlaneEq, cond_limit: float = 1e6
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The intersection point of three planes, and whether it is valid."""
    n = torch.stack([eq1.normal, eq2.normal, eq3.normal], dim=-2)
    d = torch.stack([eq1.d, eq2.d, eq3.d], dim=-1)
    return _solve_corner(n, d, cond_limit)


def _solve_corner(n: torch.Tensor, d: torch.Tensor, cond_limit: float):
    # unit normals: |det| lies in [0, 1]; a tiny one means parallel planes
    valid = torch.linalg.det(n).abs() > (1.0 / cond_limit)
    eye = torch.eye(3, dtype=n.dtype, device=n.device)
    safe_n = torch.where(valid[..., None, None], n, eye)
    x = torch.linalg.solve(safe_n, d[..., None])[..., 0]
    return torch.where(valid[..., None], x, torch.full_like(x, float("nan"))), valid


def plane_corners_batch(
    eqs: PlaneEq, triples: torch.Tensor, cond_limit: float = 1e6
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Corners of a (T, 3) index array of plane triples in one batched
    solve: points (T, 3) and validity (T,)."""
    return _solve_corner(eqs.normal[triples], eqs.d[triples], cond_limit)


def max_face_distance(eq: PlaneEq, points: torch.Tensor) -> torch.Tensor:
    """Max |signed distance| of the points to the plane (the cuboid
    faces' membership metric)."""
    return signed_distance_to_plane(eq, points).abs().max(dim=-1).values
