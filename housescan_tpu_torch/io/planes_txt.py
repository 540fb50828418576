"""planes.txt reader/writer: the PCL plane-detection interchange format.

One plane per line, ``a b c d`` in PCL's ``ax + by + cz + d = 0``
convention; the package's planes are ``n . x = d``, so d is negated on
both load and save. A copy of ``housescan_tpu/io/planes_txt.py``; the
file written is byte-identical to the reference's.
"""

from __future__ import annotations

from pathlib import Path
from typing import Union

import numpy as np
import torch

from housescan_tpu_torch.geometry.plane import PlaneEq, mk_plane_eq
from housescan_tpu_torch.io import host


class PlanesTxtError(ValueError):
    pass


def load_planes_txt(path: Union[str, Path]) -> PlaneEq:
    """Parse planes.txt into a batched PlaneEq of K planes (CPU tensors)."""
    rows = []
    for ln, line in enumerate(Path(path).read_text().splitlines(), 1):
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        parts = line.split()
        if len(parts) != 4:
            raise PlanesTxtError(f"{path}:{ln}: expected 4 coefficients, got {len(parts)}")
        try:
            rows.append([float(p) for p in parts])
        except ValueError:
            raise PlanesTxtError(f"{path}:{ln}: non-numeric coefficient") from None
    if not rows:
        raise PlanesTxtError(f"{path}: no planes found")
    arr = torch.from_numpy(np.asarray(rows, np.float32))
    return mk_plane_eq(arr[:, :3], -arr[:, 3])


def save_planes_txt(path: Union[str, Path], eqs: PlaneEq) -> None:
    """Write planes in PCL's ``ax + by + cz + d = 0`` convention."""
    normal = host(eqs.normal).astype(np.float64)
    d = host(eqs.d).astype(np.float64)
    if normal.ndim == 1:
        normal, d = normal[None], d[None]
    lines = [f"{n[0]:.9g} {n[1]:.9g} {n[2]:.9g} {-dv:.9g}" for n, dv in zip(normal, d)]
    Path(path).write_text("\n".join(lines) + "\n")
