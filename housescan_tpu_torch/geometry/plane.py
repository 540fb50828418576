"""Plane algebra in Hessian normal form ``n . x = d``.

``normal`` has shape (..., 3) (unit length) and ``d`` shape (...,), so
every operation is batched. Only what the scan stage uses is ported from
``housescan_tpu/geometry/plane.py``: ``PlaneEq`` and ``mk_plane_eq``.
PCL's ``ax + by + cz + d = 0`` converts by negating d.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


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
