"""Twins of ``tests/test_solvers.py`` on the port's solvers (CPU), with the
reference's bounds, and parity with the reference's functions on the same
numpy inputs:

- ``_lst_sq_f64`` (host float64) to 1e-9, ``lst_sq_distances_dense``
  (float32 on the device) to 1e-5;
- Nelder-Mead and the cuboid fit by what they reach, not by their
  iterates: the final objective within 1e-6 + 1e-4 of the reference's,
  the fitted cuboid's corners as a point set within 3e-4 m of the
  reference's (measured: 7e-5 on corners with 2 cm noise). Quaternion
  signs are not compared.
"""

import numpy as np
import pytest
import torch

from housescan_tpu_torch.geometry.transform import axis_angle_mat, quat_rot_mat, rotate_around
from housescan_tpu_torch.solvers import (
    cuboid_from_params,
    errfun,
    fit_cuboid,
    fit_cuboid_batch,
    fit_cuboid_from_center,
    fit_cuboid_from_center_first,
    guess_dims,
    lst_sq_distances,
    lst_sq_distances_dense,
    nelder_mead,
)
from housescan_tpu_torch.solvers.cuboid_fit import errfun_closest, refine_bfgs
from housescan_tpu_torch.solvers.nelder_mead import nelder_mead_batch
from housescan_tpu_torch.solvers.translation_optimizer import _lst_sq_f64

CPU = "cpu"


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture
def rng():
    return np.random.default_rng(0)


class TestLstSqDistances:
    def test_simple_chain(self):
        pos, rmse = lst_sq_distances({("a", "b"): 2.0, ("b", "c"): 3.0})
        assert pos["a"] == pytest.approx(0.0)
        assert pos["b"] == pytest.approx(2.0)
        assert pos["c"] == pytest.approx(5.0)
        assert rmse == pytest.approx(0.0, abs=1e-9)

    def test_inconsistent_triangle_distributes_error(self):
        pos, rmse = lst_sq_distances({(0, 1): 1.0, (1, 2): 1.0, (0, 2): 3.0})
        assert rmse > 0.1
        assert pos[1] == pytest.approx(4.0 / 3.0, abs=1e-6)
        assert pos[2] == pytest.approx(8.0 / 3.0, abs=1e-6)

    def test_negative_distances(self):
        pos, _ = lst_sq_distances({("x", "y"): -4.0})
        assert pos["y"] == pytest.approx(-4.0)

    def test_empty_returns_none(self):
        assert lst_sq_distances({}) is None

    def test_first_node_anchored_at_zero(self):
        pos, _ = lst_sq_distances({("r5", "r2"): 7.0, ("r2", "r9"): 1.0})
        assert pos["r5"] == 0.0

    def test_dense_core(self):
        edges = torch.tensor([[0, 1], [1, 2], [0, 2]])
        pos, rmse, ok = lst_sq_distances_dense(edges, torch.tensor([1.0, 1.0, 3.0]), 3)
        assert bool(ok)
        np.testing.assert_allclose(pos.numpy(), [0.0, 4 / 3, 8 / 3], atol=1e-5)
        # node 2 unconnected: rank-deficient, flagged, NaN positions (no raise)
        pos, _, ok = lst_sq_distances_dense(torch.tensor([[0, 1]]), torch.tensor([1.0]), 3)
        assert not bool(ok) and np.isnan(pos[1:].numpy()).all()


class TestNelderMead:
    def test_quadratic_bowl(self):
        target = torch.tensor([1.0, -2.0, 3.0])
        res = nelder_mead(lambda x: ((x - target) ** 2).sum(), np.zeros(3), np.ones(3) * 0.5,
                          tol=1e-8, max_iter=500, device=CPU)
        np.testing.assert_allclose(res.x.numpy(), [1.0, -2.0, 3.0], atol=1e-3)
        assert bool(res.converged)

    def test_rosenbrock_2d(self):
        def rosen(x):
            return 100.0 * (x[1] - x[0] ** 2) ** 2 + (1 - x[0]) ** 2

        res = nelder_mead(rosen, np.array([-1.2, 1.0]), np.array([0.1, 0.1]), tol=1e-10,
                          max_iter=2000, device=CPU)
        np.testing.assert_allclose(res.x.numpy(), [1.0, 1.0], atol=1e-2)

    def test_batched(self):
        """The twin of the reference's jit + vmap test: one batched loop."""
        targets = torch.tensor([[1.0, 2.0], [-3.0, 0.5], [0.0, 0.0]])
        res = nelder_mead_batch(lambda x: ((x - targets[:, None]) ** 2).sum(-1), torch.zeros(3, 2),
                                torch.full((2,), 0.3), max_iter=300)
        np.testing.assert_allclose(res.x.numpy(), targets.numpy(), atol=1e-3)

    def test_finished_instances_freeze(self):
        """An instance that converged keeps its state while the others
        iterate, and counts its own iterations: the result is the same
        for any convergence-check interval, and each instance equals its
        solve alone."""
        scales = torch.tensor([1.0, 30.0, 0.01])

        def fun(x):
            return (scales[:, None, None] * (x - 1.0) ** 2).sum(-1) + (x[..., 0] - x[..., 1]) ** 4

        x0 = torch.tensor([[0.0, 0.5], [3.0, -2.0], [0.2, 0.1]])
        runs = [nelder_mead_batch(fun, x0, torch.full((2,), 0.1), tol=1e-7, check_every=k)
                for k in (1, 7, 64)]
        for r in runs[1:]:
            for a, b in zip(r, runs[0]):
                assert torch.equal(a, b)
        n = runs[0].n_iter
        assert len(set(n.tolist())) > 1 and bool(runs[0].converged.all())
        for i in range(3):
            alone = nelder_mead_batch(lambda x, i=i: fun_one(x, scales[i]), x0[i:i + 1],
                                      torch.full((2,), 0.1), tol=1e-7)
            assert int(alone.n_iter[0]) == int(n[i])
            assert torch.equal(alone.x[0], runs[0].x[i])

    def test_matches_reference(self):
        pytest.importorskip("jax")
        import jax.numpy as jnp

        from housescan_tpu.solvers import nelder_mead as j_nm

        res = nelder_mead(lambda x: 100.0 * (x[1] - x[0] ** 2) ** 2 + (1 - x[0]) ** 2,
                          np.array([-1.2, 1.0]), np.array([0.1, 0.1]), tol=1e-10, device=CPU)
        ref = j_nm(lambda x: 100.0 * (x[1] - x[0] ** 2) ** 2 + (1 - x[0]) ** 2,
                   jnp.array([-1.2, 1.0]), jnp.array([0.1, 0.1]), tol=1e-10)
        assert abs(float(res.fun) - float(ref.fun)) <= 1e-6 + 1e-4 * float(ref.fun)
        np.testing.assert_allclose(res.x.numpy(), np.asarray(ref.x), atol=1e-3)


def fun_one(x, scale):
    return (scale * (x - 1.0) ** 2).sum(-1) + (x[..., 0] - x[..., 1]) ** 4


def make_cuboid(rng, dims=None, rotate=True, translate=True):
    """A random ground-truth cuboid in the reference's corner order."""
    dims = np.array(dims if dims is not None else rng.uniform(1, 10, size=3))
    signs = np.array([[x, y, z] for x in (-1, 1) for y in (-1, 1) for z in (-1, 1)], np.float64)
    corners = signs * dims / 2
    if rotate:
        axis = rng.uniform(0, 3, size=3) + 1e-3
        theta = rng.uniform(0, 2 * np.pi)
        corners = corners @ axis_angle_mat(torch.tensor(axis, dtype=torch.float32), theta).numpy()
    if translate:
        corners = corners + rng.uniform(-5, 5, size=3)
    return torch.tensor(corners, dtype=torch.float32), dims


class TestCuboidFromParams:
    def test_unit_cube_identity_quat(self):
        corners = cuboid_from_params(torch.tensor([0.0, 0, 0, 2, 2, 2, 0, 0, 0, 1.0]))
        np.testing.assert_allclose(np.abs(corners.numpy()), 1.0, atol=1e-6)

    def test_center_offset(self):
        corners = cuboid_from_params(torch.tensor([10.0, 20, 30, 2, 4, 6, 0, 0, 0, 1.0]))
        np.testing.assert_allclose(corners.mean(0).numpy(), [10, 20, 30], atol=1e-5)

    def test_rotate_then_translate_equals_rotate_around_center(self, rng):
        params = torch.tensor(np.concatenate([rng.normal(size=3), rng.uniform(1, 5, 3),
                                              rng.normal(size=4)]), dtype=torch.float32)
        center = params[:3]
        local = cuboid_from_params(torch.cat([center, params[3:6], torch.tensor([0.0, 0, 0, 1])]))
        via = rotate_around(center, quat_rot_mat(params[6:10]), local)
        np.testing.assert_allclose(cuboid_from_params(params).numpy(), via.numpy(), atol=1e-5)


class TestGuessDims:
    def test_axis_aligned_exact(self):
        corners, dims = make_cuboid(np.random.default_rng(1), dims=[2, 3, 5], rotate=False,
                                    translate=False)
        np.testing.assert_allclose(np.sort(guess_dims(corners).numpy()), np.sort(dims), atol=1e-4)

    def test_rotated_exact(self, rng):
        corners, dims = make_cuboid(rng, dims=[4, 1.5, 7])
        np.testing.assert_allclose(np.sort(guess_dims(corners).numpy()), np.sort(dims), rtol=1e-3)


class TestFitCuboid:
    def test_fixed_correspondence_exact_cuboid(self, rng):
        corners, _ = make_cuboid(rng, dims=[2, 1, 1])
        fit = fit_cuboid(corners, tol=1e-8, max_iter=2000, device=CPU)
        assert float(torch.sqrt(fit.error)) < 1e-2

    def test_from_center_recovers_dims(self):
        for seed in range(5):
            corners, dims = make_cuboid(np.random.default_rng(seed), translate=False)
            fit = fit_cuboid_from_center(corners, device=CPU)
            assert float(fit.error) < 1.0, f"seed {seed}: err {float(fit.error)}"
            fitted_dims = np.sort(np.abs(fit.params[3:6].numpy()))
            np.testing.assert_allclose(fitted_dims, np.sort(dims), rtol=0.05)

    def test_two_stage_fit_translated_cuboid(self, rng):
        corners, dims = make_cuboid(rng, dims=[3, 4, 5])
        fit = fit_cuboid_from_center_first(corners, device=CPU)
        assert float(fit.error) < 1e-2
        fitted = cuboid_from_params(fit.params)
        d = ((corners[:, None, :] - fitted[None, :, :]) ** 2).sum(-1).min(dim=1).values
        assert bool((torch.sqrt(d) < 0.05).all())

    def test_bfgs_polish_never_worse_and_improves_noisy_fit(self, rng):
        corners, _ = make_cuboid(rng, dims=[3, 4, 5])
        noisy = corners + torch.tensor(0.02 * rng.normal(size=corners.shape), dtype=torch.float32)
        plain = fit_cuboid_from_center_first(noisy, device=CPU)
        polished = fit_cuboid_from_center_first(noisy, polish_bfgs=True, device=CPU)
        assert float(polished.error) <= float(plain.error) + 1e-7
        assert bool(torch.isfinite(polished.params).all())
        rough = plain.params + 0.01
        x, err = refine_bfgs(noisy, rough, device=CPU)
        assert float(err) <= float(errfun_closest(noisy, rough)) + 1e-7
        assert float(err) < float(errfun_closest(noisy, rough))  # the polish moved it
        assert bool(torch.isfinite(x).all())

    def test_batch_fit_matches_single(self):
        batch = torch.stack([make_cuboid(np.random.default_rng(s))[0] for s in (10, 11, 12, 13)])
        fits = fit_cuboid_batch(batch, device=CPU)
        assert tuple(fits.params.shape) == (4, 10)
        for i in range(4):
            single = fit_cuboid_from_center_first(batch[i], device=CPU)
            assert float(fits.error[i]) < max(2.0 * float(single.error) + 1e-3, 1e-2)

    def test_errfun_zero_for_exact_params(self):
        params = torch.tensor([1.0, 2, 3, 2, 3, 4, 0.3, -0.2, 0.5, 0.8])
        assert float(errfun(cuboid_from_params(params), params)) < 1e-8

    def test_float64_input_fits_in_float32(self, rng):
        corners, _ = make_cuboid(rng, dims=[3, 4, 5])
        fit = fit_cuboid_from_center_first(corners.numpy().astype(np.float64), device=CPU)
        assert fit.params.dtype == torch.float32 and float(fit.error) < 1e-2


class TestParity:
    """The same numpy inputs through the reference's solvers."""

    @pytest.fixture(autouse=True)
    def _ref(self):
        pytest.importorskip("jax")

    def test_lst_sq_matches(self, rng):
        import jax.numpy as jnp

        from housescan_tpu.solvers.translation_optimizer import _lst_sq_f64 as j_f64
        from housescan_tpu.solvers.translation_optimizer import lst_sq_distances_dense as j_dense

        for n in (2, 4, 7):
            edges = np.array([[i, i + 1] for i in range(n - 1)] +
                             [list(rng.choice(n, 2, replace=False)) for _ in range(n)], np.int32)
            dists = rng.normal(size=len(edges))
            p, r, ok = _lst_sq_f64(edges, dists, n)
            jp, jr, jok = j_f64(edges, dists, n)
            assert ok == jok
            np.testing.assert_allclose(p, jp, atol=1e-9, rtol=0)
            assert abs(r - jr) <= 1e-9
            p, r, ok = lst_sq_distances_dense(torch.from_numpy(edges).long(),
                                              torch.tensor(dists, dtype=torch.float32), n)
            jp, jr, jok = j_dense(jnp.asarray(edges), jnp.asarray(dists, jnp.float32), n)
            assert bool(ok) == bool(jok)
            np.testing.assert_allclose(p.numpy(), np.asarray(jp), atol=1e-5, rtol=0)
            assert abs(float(r) - float(jr)) <= 1e-5

    @pytest.mark.parametrize("noise", [0.0, 0.02])
    def test_cuboid_fit_matches(self, noise):
        import jax.numpy as jnp

        from housescan_tpu.solvers import cuboid_fit as J

        for seed in (3, 4):
            r = np.random.default_rng(seed)
            corners, _ = make_cuboid(r)
            pts = (corners.numpy() + noise * r.normal(size=(8, 3))).astype(np.float32)
            fit = fit_cuboid_from_center_first(pts, device=CPU)
            ref = J.fit_cuboid_from_center_first(jnp.asarray(pts))
            assert abs(float(fit.error) - float(ref.error)) <= 1e-6 + 1e-4 * float(ref.error)
            a = cuboid_from_params(fit.params).numpy()
            b = np.asarray(J.cuboid_from_params(ref.params))
            d = np.sqrt(((a[:, None] - b[None]) ** 2).sum(-1))
            assert d.min(axis=1).max() < 3e-4 and d.min(axis=0).max() < 3e-4
            assert float(errfun_closest(torch.from_numpy(pts), fit.params)) == \
                pytest.approx(float(fit.error), rel=1e-5, abs=1e-9)
