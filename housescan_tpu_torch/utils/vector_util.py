"""Order statistics over point arrays: a port of
``housescan_tpu/utils/vector_util.py``.

The k-th smallest or largest element by a key: ``numpy.argpartition`` for
host keys, a stable sort for tensors. ``jax.lax.top_k`` breaks ties toward
the lower index; ``torch.topk`` on CUDA gives ties no order, so where an
index is returned the port sorts stably (ties keep index order, as
``top_k``), and ``top_fraction_threshold``, which returns a value only,
uses ``torch.topk``.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch


def _check_k(name: str, k: int) -> None:
    if k < 1:
        raise ValueError(f"{name}: k must be >= 1, got {k}")


def kth_smallest_by(key: Callable, k: int, points):
    """Element of ``points`` (axis 0) with the k-th smallest key,
    1-indexed: ``kth_smallest_by(f, 1, v)`` is the minimum by ``f``."""
    _check_k("kth_smallest_by", k)
    keys = key(points)
    if isinstance(keys, np.ndarray):
        return points[int(np.argpartition(keys, k - 1)[k - 1])]
    return points[torch.sort(keys, stable=True).indices[k - 1]]


def kth_largest_by(key: Callable, k: int, points):
    """Element of ``points`` (axis 0) with the k-th largest key, 1-indexed."""
    _check_k("kth_largest_by", k)
    keys = key(points)
    if isinstance(keys, np.ndarray):
        return points[int(np.argpartition(-keys, k - 1)[k - 1])]
    return points[torch.sort(keys, descending=True, stable=True).indices[k - 1]]


def top_fraction_threshold(values: torch.Tensor, fraction: float) -> torch.Tensor:
    """The key below which all but the top ``fraction`` of ``values`` lie:
    with ``fraction=0.2``, the (n // 5)-th largest value."""
    n = values.shape[0]
    n_discard = n // int(round(1.0 / fraction)) if fraction > 0 else 0
    if n_discard < 1:
        return values.max() if n else torch.tensor(float("inf"), dtype=values.dtype,
                                                   device=values.device)
    return torch.topk(values, n_discard).values[-1]
