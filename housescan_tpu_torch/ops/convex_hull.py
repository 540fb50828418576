"""The scan's plane hulls by the compiled monotone chain.

``kinfu/ransac.plane_hulls`` takes this path for a cloud on the card: one
call a plane of ``hs_convex_hull_2d`` (``csrc/convex_hull.cu``), a
host-only routine of the kernel library, through ctypes. It returns what
the Python chain (``kinfu/ransac.convex_hull_2d``, the plain twin, which
runs for a cloud off the card) returns, byte for byte: the same float64
rows in the same order.

Host code and not a kernel: the chain is sequential, its input is numpy's
float64 projection of the inliers (whose bits the card would not repeat),
and the reference's hull is host numpy too.
"""

from __future__ import annotations

import numpy as np

from housescan_tpu_torch.ops import cuda_lib


def sorted_unique(points_2d) -> np.ndarray:
    """``np.unique(points_2d, axis=0)`` as float64 (the rows sorted by x,
    then y), from one sort and a mask of rows unequal to the row before.
    The sort takes each row as a complex number, which numpy orders by
    the real part, then the imaginary: about three times faster than a
    lexsort of the two columns. Where two rows compare equal but differ in
    their bits (0.0 and -0.0) or a value is NaN, it is ``np.unique``
    itself: which of two such rows ``np.unique`` keeps, or where it sorts
    a NaN, follows its own sort."""
    pts = np.ascontiguousarray(points_2d, np.float64)
    srt = np.sort(pts.view(np.complex128).ravel()).view(np.float64).reshape(-1, 2)
    same = (srt[1:] == srt[:-1]).all(axis=1)
    bits = srt.view(np.int64)
    if np.isnan(srt).any() or (same & (bits[1:] != bits[:-1]).any(axis=1)).any():
        return np.unique(pts, axis=0)
    keep = np.ones(len(srt), bool)
    keep[1:] = ~same
    return srt[keep]


def convex_hull_compiled(pts: np.ndarray) -> np.ndarray:
    """``kinfu/ransac.monotone_chain(pts)`` by the compiled chain, for
    ``sorted_unique``'s float64 rows (sorted by x, then y): the
    strict hull's vertices, the lower chain then the upper; two rows or
    fewer come back as they are."""
    n = len(pts)
    if n <= 2:
        return pts
    pts = np.ascontiguousarray(pts, np.float64)
    out = np.empty(2 * n - 2, np.int64)
    stack = np.empty(n, np.int64)
    m = cuda_lib.load().hs_convex_hull_2d(pts.ctypes.data, n, out.ctypes.data, stack.ctypes.data)
    return pts[out[:m]]
