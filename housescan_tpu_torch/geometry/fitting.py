"""Weighted total-least-squares plane fit (``housescan_tpu/geometry/
fitting.py:fit_plane_weighted``; the rest of that module is not ported).

The normal is the eigenvector of the 3x3 weighted scatter matrix with the
smallest eigenvalue (``torch.linalg.eigh`` sorts ascending, as
``jnp.linalg.eigh``), and d places the plane through the weighted
centroid. float32 throughout; on the card the matmuls need TF32 off
(``geometry/transform.full_fp32_matmul``), which every entry point sets.
"""

from __future__ import annotations

import torch

from housescan_tpu_torch.geometry.plane import PlaneEq
from housescan_tpu_torch.geometry.transform import mm


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
