""".xf transform files (plyxform-compatible): a copy of
``housescan_tpu/io/xf.py``.

A room's cumulative transform goes out as a 4-line .xf file in the
left-multiplicative (column-vector) convention, the transpose of the
package's row-vector form; save and load transpose symmetrically.
"""

from __future__ import annotations

from pathlib import Path
from typing import Union

import numpy as np

from housescan_tpu_torch.io import host


def save_xf(path: Union[str, Path], proj_rowvec) -> None:
    """Write a row-vector 4x4 transform as a left-multiplicative .xf file."""
    m = host(proj_rowvec).astype(np.float64).T  # to the column-vector convention
    lines = [" ".join(repr(float(v)) for v in row) for row in m]
    Path(path).write_text("\n".join(lines) + "\n")


def load_xf(path: Union[str, Path]) -> np.ndarray:
    """Read a .xf file back into the row-vector convention (float64)."""
    values = [float(t) for t in Path(path).read_text().split()]
    if len(values) != 16:
        raise ValueError(f"{path}: .xf must contain 16 numbers, got {len(values)}")
    return np.asarray(values, np.float64).reshape(4, 4).T
