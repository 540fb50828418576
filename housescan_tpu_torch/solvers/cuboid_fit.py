"""Oriented-cuboid fitting to 8 corner points, batched on the device.

A port of ``housescan_tpu/solvers/cuboid_fit.py``. A cuboid is 10
parameters: center (x, y, z), dimensions (a, b, c) and an unnormalized
quaternion (q1..q4). Three strategies:

- ``fit_cuboid``: fixed point-to-corner correspondences;
- ``fit_cuboid_from_center``: the center pinned at the point mean, the
  nearest corner as correspondence, multi-start over 8 quaternion seeds;
- ``fit_cuboid_from_center_first``: the production two-stage fit
  (pinned center first, then all 10 free), which ``fit_cuboid_to_room``
  uses.

The reference vmaps the seeds (and ``fit_cuboid_batch`` the rooms); here
every (room, seed) pair is one instance of ``nelder_mead_batch``, so a
batch of rooms is one device loop. The objectives broadcast over leading
dimensions. Inputs become float32 (``geometry.transform.f32``), as
``jnp.asarray`` makes them.

``refine_bfgs`` replaces ``jax.scipy.optimize.minimize(method="BFGS")``:
a BFGS with a strong-Wolfe line search in torch ops, the gradient of the
softmin objective by ``torch.autograd``. It is held to the reference's
acceptance rule (finite, and never worse on the hard nearest-corner
objective), not to its iterates.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from housescan_tpu_torch.geometry.transform import f32, mm, quat_rot_mat
from housescan_tpu_torch.solvers.nelder_mead import nelder_mead_batch

# Corner sign pattern in the reference's corner order: x slowest, z fastest.
_CORNER_SIGNS = np.array(
    [[x, y, z] for x in (-1, 1) for y in (-1, 1) for z in (-1, 1)], np.float32
)

# Quaternion multi-start seeds (the reference's own seed first).
_QUAT_SEEDS = np.array(
    [
        [0.1, 0.1, 0.1, 0.1],
        [0.0, 0.0, 0.0, 1.0],  # identity
        [0.383, 0.0, 0.0, 0.924],  # 45 deg about x
        [0.0, 0.383, 0.0, 0.924],  # 45 deg about y
        [0.0, 0.0, 0.383, 0.924],  # 45 deg about z
        [0.271, 0.271, 0.271, 0.884],  # 45 deg about the diagonal
        [0.5, 0.5, 0.0, 0.707],
        [0.0, 0.5, 0.5, 0.707],
    ],
    np.float32,
)


def cuboid_from_params(params: torch.Tensor) -> torch.Tensor:
    """(..., 10) params -> (..., 8, 3) corners: spawned at the origin,
    rotated by the quaternion, moved to the center."""
    signs = torch.as_tensor(_CORNER_SIGNS, dtype=params.dtype, device=params.device)
    local = signs * (params[..., None, 3:6] / 2.0)
    return mm(local, quat_rot_mat(params[..., 6:10])) + params[..., None, 0:3]


def errfun(points: torch.Tensor, params: torch.Tensor) -> torch.Tensor:
    """Sum of squared distances with fixed correspondences."""
    return ((points - cuboid_from_params(params)) ** 2).sum(dim=(-2, -1))


def _closest(points: torch.Tensor, est: torch.Tensor) -> torch.Tensor:
    d2 = ((points[..., :, None, :] - est[..., None, :, :]) ** 2).sum(dim=-1)
    return d2.min(dim=-1).values.sum(dim=-1)


def errfun_closest_center(center: torch.Tensor, points: torch.Tensor, params7: torch.Tensor) -> torch.Tensor:
    """Nearest-corner objective with the center pinned; params are
    (a, b, c, q1..q4)."""
    center = torch.broadcast_to(center, params7.shape[:-1] + (3,))
    return _closest(points, cuboid_from_params(torch.cat([center, params7], dim=-1)))


def errfun_closest(points: torch.Tensor, params: torch.Tensor) -> torch.Tensor:
    """Nearest-corner objective over all 10 params."""
    return _closest(points, cuboid_from_params(params))


def guess_dims(points: torch.Tensor) -> torch.Tensor:
    """(a, b, c) seeds from the sorted distances to the first corner: a, b
    the two shortest edges, the longest the space diagonal, so c =
    sqrt(diag^2 - a^2 - b^2), clamped non-negative for noisy input."""
    d = torch.linalg.norm(points[..., 1:, :] - points[..., :1, :], dim=-1)
    d = torch.sort(d, dim=-1).values
    a, b, diag = d[..., 0], d[..., 1], d[..., 6]
    c = torch.sqrt(torch.clamp(diag ** 2 - a ** 2 - b ** 2, min=0.0))
    return torch.stack([a, b, c], dim=-1)


class CuboidFit(NamedTuple):
    params: torch.Tensor  # (..., 10) x y z a b c q1 q2 q3 q4
    n_steps: torch.Tensor  # (...) int32 total simplex iterations
    error: torch.Tensor  # (...) final objective (sum of squared distances)


def _from_center(points: torch.Tensor, tol: float, max_iter: int, n_starts: int) -> CuboidFit:
    """Stage 1 for (R, 8, 3) corner sets: R x n_starts instances."""
    r = points.shape[0]
    center = points.mean(dim=1)
    a = guess_dims(points)[:, 0]
    dims0 = torch.stack([a, a, a], dim=-1)
    steps = torch.cat([dims0 / 10.0, torch.full((r, 4), 0.1, dtype=points.dtype,
                                                 device=points.device)], dim=-1)
    quats = torch.as_tensor(_QUAT_SEEDS[:n_starts], dtype=points.dtype, device=points.device)
    x0 = torch.cat([dims0[:, None].expand(r, n_starts, 3), quats[None].expand(r, n_starts, 4)], -1)
    c_rep = center.repeat_interleave(n_starts, 0)[:, None]
    p_rep = points.repeat_interleave(n_starts, 0)[:, None]
    res = nelder_mead_batch(lambda x: errfun_closest_center(c_rep, p_rep, x),
                            x0.reshape(r * n_starts, 7), steps.repeat_interleave(n_starts, 0),
                            tol=tol, max_iter=max_iter)
    fun = res.fun.view(r, n_starts)
    best = torch.argmin(fun, dim=1)
    rows = torch.arange(r, device=points.device)
    x = res.x.view(r, n_starts, 7)[rows, best]
    return CuboidFit(torch.cat([center, x], dim=-1), res.n_iter.view(r, n_starts).sum(dim=1),
                     fun[rows, best])


def _two_stage(points: torch.Tensor, tol: float, max_iter: int) -> CuboidFit:
    """Both stages for (R, 8, 3) corner sets."""
    stage1 = _from_center(points, tol, max_iter, len(_QUAT_SEEDS))
    a = guess_dims(points)[:, 0:1]
    ones = torch.ones_like(a)
    steps = torch.cat([0.01 * ones.expand(-1, 3), a.expand(-1, 3) / 10.0, 0.1 * ones.expand(-1, 4)],
                      dim=-1)
    res = nelder_mead_batch(lambda x: errfun_closest(points[:, None], x), stage1.params, steps,
                            tol=tol, max_iter=max_iter)
    return CuboidFit(res.x, stage1.n_steps + res.n_iter, res.fun)


def fit_cuboid_from_center(
    points, tol: float = 1e-8, max_iter: int = 2000, n_starts: int = 8, device="cuda"
) -> CuboidFit:
    """Stage 1 alone: center fixed at the point mean, 7 free params,
    multi-start over quaternion seeds."""
    fit = _from_center(f32(points, device)[None], tol, max_iter, n_starts)
    return CuboidFit(*(t[0] for t in fit))


def fit_cuboid_from_center_first(
    points, tol: float = 1e-8, max_iter: int = 2000, polish_bfgs: bool = False, device="cuda"
) -> CuboidFit:
    """The two-stage production fit: pinned center first, then all 10
    free. ``polish_bfgs=True`` adds ``refine_bfgs``, kept only where it
    improves the nearest-corner objective."""
    pts = f32(points, device)
    fit = CuboidFit(*(t[0] for t in _two_stage(pts[None], tol, max_iter)))
    if polish_bfgs:
        x, err = refine_bfgs(pts, fit.params, device=pts.device)
        fit = CuboidFit(x, fit.n_steps, err)
    return fit


def fit_cuboid(points, tol: float = 1e-8, max_iter: int = 2000, device="cuda") -> CuboidFit:
    """Fixed-correspondence fit: the points must be in corner order."""
    pts = f32(points, device)
    dims = guess_dims(pts)
    x0 = torch.cat([pts.mean(dim=0), dims, torch.full((4,), 0.1, device=pts.device)])
    steps = torch.cat([torch.full((3,), 0.01, device=pts.device), (dims[0] / 10.0).expand(3),
                       torch.full((4,), 0.1, device=pts.device)])
    res = nelder_mead_batch(lambda x: errfun(pts[None, None], x), x0[None], steps[None],
                            tol=tol, max_iter=max_iter)
    return CuboidFit(res.x[0], res.n_iter[0], res.fun[0])


def fit_cuboid_batch(points_batch, tol: float = 1e-8, max_iter: int = 2000,
                     device="cuda") -> CuboidFit:
    """Fit cuboids to a (B, 8, 3) batch of corner sets in one device
    loop (B x 8 instances in stage 1, B in stage 2)."""
    return _two_stage(f32(points_batch, device), tol, max_iter)


def _strong_wolfe(phi, f0: float, g0: float, alpha1: float = 1.0, c1: float = 1e-4,
                  c2: float = 0.9, max_iter: int = 30):
    """Line search for a step meeting the strong Wolfe conditions
    (Nocedal and Wright, algorithms 3.5 and 3.6, with bisection in the
    zoom). ``phi(alpha)`` -> (f, directional derivative, payload).
    Returns (alpha, payload), or None when no step is found."""

    def zoom(lo, hi, f_lo):
        for _ in range(max_iter):
            a = 0.5 * (lo + hi)
            f, g, pay = phi(a)
            if not np.isfinite(f) or f > f0 + c1 * a * g0 or f >= f_lo:
                hi = a
            else:
                if abs(g) <= -c2 * g0:
                    return a, pay
                if g * (hi - lo) >= 0:
                    hi = lo
                lo, f_lo = a, f
        return None

    a_prev, f_prev, a = 0.0, f0, alpha1
    for i in range(max_iter):
        f, g, pay = phi(a)
        if not np.isfinite(f) or f > f0 + c1 * a * g0 or (i > 0 and f >= f_prev):
            return zoom(a_prev, a, f_prev)
        if abs(g) <= -c2 * g0:
            return a, pay
        if g >= 0:
            return zoom(a, a_prev, f)
        a_prev, f_prev, a = a, f, 2.0 * a
    return None


def refine_bfgs(points, params, device="cuda", max_iter: int = 200,
                gtol: float = 1e-5) -> Tuple[torch.Tensor, torch.Tensor]:
    """Polish a simplex solution with BFGS on a smoothed nearest-corner
    objective (a softmin for the hard min, so the objective is C^1).
    Returns (params, hard objective): the BFGS point when it is finite
    and strictly better on the hard objective, else ``params``."""
    pts = f32(points, device)
    p0 = f32(params, pts.device)

    def value_and_grad(p):
        p = p.detach().requires_grad_(True)
        with torch.enable_grad():
            est = cuboid_from_params(p)
            d2 = ((pts[:, None, :] - est[None, :, :]) ** 2).sum(dim=-1)
            t = 1e-3 + d2.min()  # softmin temperature ~ the objective's scale
            f = (-t * torch.logsumexp(-d2 / t, dim=1)).sum()
            (g,) = torch.autograd.grad(f, p)
        return f.detach(), g

    x = p0.clone()
    f, g = value_and_grad(x)
    h = torch.eye(10, dtype=x.dtype, device=x.device)
    for _ in range(max_iter):
        if not bool(torch.isfinite(g).all()) or float(g.abs().max()) <= gtol:
            break
        d = -mm(h, g)

        def phi(a, x=x, d=d):
            fa, ga = value_and_grad(x + a * d)
            return float(fa), float(torch.dot(ga, d)), (fa, ga)

        found = _strong_wolfe(phi, float(f), float(torch.dot(g, d)))
        if found is None:
            break
        alpha, (f_new, g_new) = found
        s = alpha * d
        y = g_new - g
        rho = 1.0 / torch.dot(y, s)
        rho = torch.where(torch.isinf(rho), torch.full_like(rho, 1000.0), rho)
        eye = torch.eye(10, dtype=x.dtype, device=x.device)
        left = eye - rho * torch.outer(s, y)
        h = mm(mm(left, h), left.T) + rho * torch.outer(s, s)
        x, f, g = x + s, f_new, g_new

    hard = errfun_closest(pts, x)
    better = bool(torch.isfinite(x).all()) and bool(hard < errfun_closest(pts, p0))
    x = x if better else p0
    return x, errfun_closest(pts, x)
