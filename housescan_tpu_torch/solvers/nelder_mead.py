"""Batched Nelder-Mead simplex minimizer on the device.

A port of ``housescan_tpu/solvers/nelder_mead.py``: GSL NMSimplex2-style
steps (reflection 1, expansion 2, contraction 0.5, shrink 0.5) and its
size measure, the mean distance of the vertices from the centroid. The
reference is a ``lax.while_loop`` that ``vmap`` batches over starts and
rooms; under ``vmap`` an instance that has converged keeps its state
while the others iterate. ``nelder_mead_batch`` does the same on a
(B, n) batch: every iteration updates only the instances still active
(iterations left and size above tolerance) and counts ``n_iter`` for
each instance.

Two things keep the card busy rather than the host:

- Each iteration evaluates every candidate vertex of every instance in
  one call of the objective: the reflected, expanded, both contracted
  (outside and inside) and the n + 1 shrunk vertices, then selects, as
  the reference's ``jnp.where`` does. The outside and inside
  contractions are both evaluated so that the choice between them needs
  no second call; each is the reference's candidate on its branch.
- Convergence is read on the host every ``check_every`` iterations, not
  every iteration (up to 2,000 synchronisations a fit). A finished
  instance is frozen, so the result does not depend on ``check_every``.

``jnp.argsort`` is stable and ``torch.argsort`` is not by default: the
vertices are ordered with ``stable=True``, or ties between equal values
would order differently. The tolerance floor uses ``torch.finfo``.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from housescan_tpu_torch.geometry.transform import f32


class NelderMeadResult(NamedTuple):
    x: torch.Tensor  # (..., n) best vertex
    fun: torch.Tensor  # (...) best value
    n_iter: torch.Tensor  # (...) int32 iterations used
    converged: torch.Tensor  # (...) bool: simplex size fell below tol


def _simplex_size(simplex: torch.Tensor) -> torch.Tensor:
    centroid = simplex.mean(dim=-2, keepdim=True)
    return torch.linalg.norm(simplex - centroid, dim=-1).mean(dim=-1)


def nelder_mead_batch(
    fun: Callable[[torch.Tensor], torch.Tensor],
    x0: torch.Tensor,
    step_sizes: torch.Tensor,
    tol: float = 1e-8,
    max_iter: int = 2000,
    *,
    check_every: int = 32,
) -> NelderMeadResult:
    """Minimize B problems from the (B, n) starts ``x0`` with axis-aligned
    initial simplices: vertex i + 1 = x0 + step_sizes[..., i] e_i
    (``step_sizes`` (n,) or (B, n)).

    ``fun`` maps (B, K, n) vertices to (B, K) values; instance b's data
    sit at row b of whatever it closes over. Runs on ``x0``'s device."""
    dtype, device = x0.dtype, x0.device
    bsz, n = x0.shape
    steps = torch.as_tensor(step_sizes, dtype=dtype, device=device).expand(bsz, n)
    # Tolerance floor: GSL's 1e-8 assumes float64; in float32 the simplex
    # bottoms out near eps * parameter scale.
    scale = torch.linalg.norm(x0, dim=-1) + torch.linalg.norm(steps, dim=-1) + 1.0
    eff_tol = torch.clamp(8.0 * torch.finfo(dtype).eps * scale, min=tol)

    simplex = torch.cat([x0[:, None, :], x0[:, None, :] + torch.diag_embed(steps)], dim=1)
    fvals = fun(simplex)
    n_iter = torch.zeros(bsz, dtype=torch.int32, device=device)
    rows = torch.arange(bsz, device=device)

    for it in range(max_iter):
        active = (_simplex_size(simplex) > eff_tol) & (n_iter < max_iter)
        if it % check_every == 0 and not bool(active.any()):
            break
        order = torch.argsort(fvals, dim=-1, stable=True)
        simplex = simplex[rows[:, None], order]
        fvals = torch.gather(fvals, 1, order)
        best_f, second_worst_f, worst_f = fvals[:, 0], fvals[:, n - 1], fvals[:, n]
        centroid = simplex[:, :n].mean(dim=1)
        worst = simplex[:, n]
        reflected = centroid + (centroid - worst)
        expanded = centroid + 2.0 * (centroid - worst)
        contracted_out = centroid + 0.5 * (reflected - centroid)
        contracted_in = centroid + 0.5 * (worst - centroid)
        shrunk = simplex[:, :1] + 0.5 * (simplex - simplex[:, :1])
        cand = torch.cat([torch.stack([reflected, expanded, contracted_out, contracted_in], 1),
                          shrunk], dim=1)
        f_cand = fun(cand)
        f_reflected, f_expanded = f_cand[:, 0], f_cand[:, 1]
        # contract toward the better of worst and reflected
        use_outside = f_reflected < worst_f
        contracted = torch.where(use_outside[:, None], contracted_out, contracted_in)
        f_contracted = torch.where(use_outside, f_cand[:, 2], f_cand[:, 3])

        do_expand = (f_reflected < best_f) & (f_expanded < f_reflected)
        do_reflect = ~do_expand & (f_reflected < second_worst_f)
        do_contract = ~do_expand & ~do_reflect & (f_contracted < torch.minimum(f_reflected, worst_f))
        do_shrink = ~(do_expand | do_reflect | do_contract)

        new_vertex = torch.where(do_expand[:, None], expanded,
                                 torch.where(do_reflect[:, None], reflected, contracted))
        new_f = torch.where(do_expand, f_expanded, torch.where(do_reflect, f_reflected, f_contracted))
        replaced = torch.cat([simplex[:, :n], new_vertex[:, None]], dim=1)
        replaced_f = torch.cat([fvals[:, :n], new_f[:, None]], dim=1)
        stepped = torch.where(do_shrink[:, None, None], shrunk, replaced)
        stepped_f = torch.where(do_shrink[:, None], f_cand[:, 4:], replaced_f)
        # a finished instance keeps its state (the batched while_loop's rule)
        simplex = torch.where(active[:, None, None], stepped, simplex)
        fvals = torch.where(active[:, None], stepped_f, fvals)
        n_iter = n_iter + active.to(torch.int32)

    best = torch.argmin(fvals, dim=-1)
    return NelderMeadResult(
        x=simplex[rows, best],
        fun=fvals[rows, best],
        n_iter=n_iter,
        converged=_simplex_size(simplex) <= eff_tol,
    )


def nelder_mead(
    fun: Callable[[torch.Tensor], torch.Tensor],
    x0: torch.Tensor,
    step_sizes: torch.Tensor,
    tol: float = 1e-8,
    max_iter: int = 2000,
    *,
    device="cuda",
) -> NelderMeadResult:
    """Minimize the scalar function ``fun`` of an (n,) vector from ``x0``
    (the reference's signature) on ``device``: ``nelder_mead_batch`` on a
    batch of one, with ``fun`` vectorized by ``torch.func.vmap``. ``x0``
    and ``step_sizes`` become float32, as ``jnp.asarray`` makes them."""
    x0, steps = f32(x0, device), f32(step_sizes, device)
    batched = torch.func.vmap(torch.func.vmap(fun))
    res = nelder_mead_batch(batched, x0[None], steps[None], tol=tol, max_iter=max_iter)
    return NelderMeadResult(*(t[0] for t in res))
