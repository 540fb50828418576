"""1-D least-squares positioning from pairwise signed-distance constraints.

A port of ``housescan_tpu/solvers/translation_optimizer.py``: an edge
``(i, j) -> d`` asks node j to sit at signed offset d from node i; the
positions minimize the squared violations, with the first node pinned at
0 by dropping its column from the difference matrix (which also makes a
connected graph's system full-rank).

Two layers, as in the reference:

- ``lst_sq_distances_dense``, the float32 core on index tensors, on the
  device of its arguments (the card by default through its callers);
- ``lst_sq_distances``, the keyed API ``{(a, b): d}``, which solves on
  the host in float64 numpy (``_lst_sq_f64``, copied as it is: the
  systems are tiny, and float64 is the reference's choice there).

A rank-deficient system is reported by an ``ok`` flag (dense) or None
(keyed). ``torch.linalg.solve`` raises on a singular matrix, so the
identity is swapped in before the solve, as the reference does.
"""

from __future__ import annotations

from typing import Dict, Hashable, Optional, Tuple, TypeVar

import numpy as np
import torch

from housescan_tpu_torch.geometry.transform import mm
from housescan_tpu_torch.utils.bijection import biject, ord_nub

K = TypeVar("K", bound=Hashable)


def lst_sq_distances_dense(
    edges: torch.Tensor, dists: torch.Tensor, n_nodes: int
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Dense-index least squares: ``edges`` (E, 2) node indices,
    ``dists`` (E,) the desired position[j] - position[i]. Returns
    positions (n_nodes,) with position[0] == 0, rmse
    sqrt(sum(residual^2) / E), and ok (False when rank-deficient)."""
    e = edges.shape[0]
    dtype, device = dists.dtype, dists.device
    rows = torch.arange(e, device=device)
    a_full = torch.zeros((e, n_nodes), dtype=dtype, device=device)
    a_full.index_put_((rows, edges[:, 0]), torch.full((e,), -1.0, dtype=dtype, device=device),
                      accumulate=True)
    a_full.index_put_((rows, edges[:, 1]), torch.ones(e, dtype=dtype, device=device),
                      accumulate=True)
    a = a_full[:, 1:]
    gram = mm(a.T, a)
    rhs = mm(a.T, dists)
    eigs = torch.linalg.eigvalsh(gram)
    ok = eigs[0] > 1e-9 * torch.clamp(eigs[-1], min=1e-30)
    eye = torch.eye(gram.shape[0], dtype=dtype, device=device)
    x = torch.linalg.solve(torch.where(ok, gram, eye), rhs)
    x = torch.where(ok, x, torch.full_like(x, float("nan")))
    positions = torch.cat([torch.zeros(1, dtype=dtype, device=device), x])
    residual = mm(a, x) - dists
    rmse = torch.sqrt((residual ** 2).sum() / e)
    return positions, rmse, ok


def lst_sq_distances(
    dist_map: Dict[Tuple[K, K], float]
) -> Optional[Tuple[Dict[K, float], float]]:
    """Keyed API: ``{(a, b): d} -> ({node: position}, rmse)``, or None
    (no edges, or a singular system). The first node of the first edge
    sits at 0; a dict allows one distance an edge."""
    if not dist_map:
        return None
    keys = list(dist_map.keys())
    index_of, _ = biject([n for a, b in keys for n in (a, b)])
    nodes = ord_nub([n for a, b in keys for n in (a, b)])
    edges = np.array([[index_of(a), index_of(b)] for a, b in keys], dtype=np.int32)
    dists = np.array([dist_map[k] for k in keys], dtype=np.float64)
    positions, rmse, ok = _lst_sq_f64(edges, dists, len(nodes))
    if not bool(ok):
        return None
    return {node: float(positions[i]) for i, node in enumerate(nodes)}, float(rmse)


def _lst_sq_f64(edges: np.ndarray, dists: np.ndarray, n_nodes: int):
    """Host float64 path (numpy lstsq, as LAPACK's dgels)."""
    e = edges.shape[0]
    a_full = np.zeros((e, n_nodes))
    a_full[np.arange(e), edges[:, 0]] += -1.0
    a_full[np.arange(e), edges[:, 1]] += 1.0
    a = a_full[:, 1:]
    if n_nodes > 1 and np.linalg.matrix_rank(a) < n_nodes - 1:
        return np.full(n_nodes, np.nan), np.nan, False
    x, _, _, _ = np.linalg.lstsq(a, dists, rcond=None)
    positions = np.concatenate([[0.0], x])
    rmse = float(np.sqrt(np.sum((a @ x - dists) ** 2) / e))
    return positions, rmse, True
