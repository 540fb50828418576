"""Twins of ``tests/test_geometry.py`` on the port's ``geometry`` (CPU
tensors), with the reference's bounds (1e-5, 1e-4 where it uses them),
and parity with the reference's functions on the same numpy inputs:
every transform, plane operation, fit and corner within 1e-5 (float32,
with the reductions in another order), the corners' validity flags
identical."""

import numpy as np
import pytest
import torch

from housescan_tpu_torch.geometry import (
    PlaneEq,
    apply_proj4,
    axis_angle_mat,
    fit_plane,
    flip_plane_eq,
    identity_proj4,
    mk_plane_eq,
    mk_plane_eq_abcd,
    plane_corner,
    plane_corners_batch,
    proj4_from_translation,
    project_to_plane,
    quat_rot_mat,
    rotate_around,
    rotation_between_normals,
    rotation_proj4_around,
    signed_distance_to_plane,
)
from housescan_tpu_torch.geometry.fitting import max_face_distance
from housescan_tpu_torch.geometry.plane import (
    rotate_plane_eq,
    rotate_plane_eq_around,
    signed_distances_pairwise,
    transform_plane_eq,
    translate_plane_eq,
)
from housescan_tpu_torch.geometry.transform import compose_proj4, transpose_for_export

ATOL = 1e-5


def t(x):
    return torch.as_tensor(np.asarray(x, np.float32))


@pytest.fixture
def rng():
    return np.random.default_rng(0)


def random_rot(rng):
    return quat_rot_mat(t(rng.normal(size=4)))


class TestRotations:
    def test_axis_angle_is_orthonormal(self, rng):
        for _ in range(10):
            m = axis_angle_mat(t(rng.normal(size=3)), rng.uniform(0, 2 * np.pi)).numpy()
            np.testing.assert_allclose(m @ m.T, np.eye(3), atol=ATOL)
            assert np.linalg.det(m) == pytest.approx(1.0, abs=1e-4)

    def test_quat_mat_orthonormal(self, rng):
        for _ in range(10):
            m = random_rot(rng).numpy()
            np.testing.assert_allclose(m @ m.T, np.eye(3), atol=ATOL)
            assert np.linalg.det(m) == pytest.approx(1.0, abs=1e-4)

    def test_axis_angle_right_hand_convention(self):
        m = axis_angle_mat(t([0.0, 0.0, 1.0]), np.pi / 2)
        np.testing.assert_allclose((t([1.0, 0.0, 0.0]) @ m).numpy(), [0.0, 1.0, 0.0], atol=ATOL)

    def test_rotate_around_center_fixes_center(self, rng):
        center = t(rng.normal(size=3))
        out = rotate_around(center, random_rot(rng), center)
        np.testing.assert_allclose(out.numpy(), center.numpy(), atol=ATOL)

    def test_rotation_between_normals(self, rng):
        for _ in range(10):
            n1, n2 = t(rng.normal(size=3)), t(rng.normal(size=3))
            rotated = (n1 @ rotation_between_normals(n1, n2)).numpy()
            cos = rotated @ n2.numpy() / (np.linalg.norm(rotated) * np.linalg.norm(n2.numpy()))
            assert cos == pytest.approx(1.0, abs=1e-4)

    def test_rotation_between_parallel_normals_is_identity(self):
        n = t([0.0, 1.0, 0.0])
        np.testing.assert_allclose(rotation_between_normals(n, n).numpy(), np.eye(3), atol=ATOL)

    def test_rotation_between_antiparallel(self):
        n = t([0.0, 1.0, 0.0])
        m = rotation_between_normals(n, -n)
        np.testing.assert_allclose((n @ m).numpy(), [0.0, -1.0, 0.0], atol=ATOL)


class TestProj4:
    def test_translation_last_row(self):
        p = proj4_from_translation(t([1.0, 2.0, 3.0]))
        np.testing.assert_allclose(p[3, :3].numpy(), [1.0, 2.0, 3.0])
        np.testing.assert_allclose(apply_proj4(p, torch.zeros(4, 3))[0].numpy(), [1.0, 2.0, 3.0])

    def test_compose_order(self):
        t1 = proj4_from_translation(t([1.0, 0.0, 0.0]))
        r = rotation_proj4_around(torch.zeros(3), axis_angle_mat(t([0.0, 0.0, 1.0]), np.pi / 2))
        out = apply_proj4(compose_proj4(t1, r), torch.zeros(1, 3))[0]
        np.testing.assert_allclose(out.numpy(), [0.0, 1.0, 0.0], atol=ATOL)

    def test_rotation_around_center_proj4_matches_pointwise(self, rng):
        center, rot = t(rng.normal(size=3)), random_rot(rng)
        pts = t(rng.normal(size=(20, 3)))
        via_proj = apply_proj4(rotation_proj4_around(center, rot), pts)
        np.testing.assert_allclose(via_proj.numpy(), rotate_around(center, rot, pts).numpy(),
                                   atol=1e-4)

    def test_export_transpose(self):
        e = transpose_for_export(proj4_from_translation(t([1.0, 2.0, 3.0])))
        np.testing.assert_allclose(e[:3, 3].numpy(), [1.0, 2.0, 3.0])

    def test_identity(self):
        pts = torch.arange(12.0).reshape(4, 3)
        np.testing.assert_allclose(apply_proj4(identity_proj4(device="cpu"), pts).numpy(), pts.numpy())


class TestPlaneEq:
    def test_mk_plane_eq_normalizes(self):
        eq = mk_plane_eq(t([0.0, 2.0, 0.0]), 4.0)
        np.testing.assert_allclose(eq.normal.numpy(), [0.0, 1.0, 0.0], atol=ATOL)
        assert float(eq.d) == pytest.approx(2.0)

    def test_signed_distance_and_flip(self):
        eq = mk_plane_eq(t([0.0, 1.0, 0.0]), 2.0)  # the plane y = 2
        p = t([5.0, 3.0, 1.0])
        assert float(signed_distance_to_plane(eq, p)) == pytest.approx(1.0)
        assert float(signed_distance_to_plane(flip_plane_eq(eq), p)) == pytest.approx(-1.0)

    def test_project_to_plane_lands_on_plane(self, rng):
        eq = mk_plane_eq(t(rng.normal(size=3)), 1.5)
        projected = project_to_plane(eq, t(rng.normal(size=(50, 3))))
        np.testing.assert_allclose(signed_distance_to_plane(eq, projected).numpy(), 0.0, atol=1e-5)

    def test_pcl_sign_convention(self):
        eq = mk_plane_eq_abcd(0.0, 1.0, 0.0, -(-2.0))
        assert float(eq.d) == pytest.approx(2.0)

    def test_rotate_plane_eq_about_origin_keeps_d(self, rng):
        eq = mk_plane_eq(t(rng.normal(size=3)), 1.23)
        assert float(rotate_plane_eq(eq, random_rot(rng)).d) == pytest.approx(float(eq.d), abs=1e-5)

    def test_rotate_plane_eq_around_is_consistent_with_points(self, rng):
        eq = mk_plane_eq(t(rng.normal(size=3)), 0.7)
        pts = project_to_plane(eq, t(rng.normal(size=(20, 3))))
        center, rot = t(rng.normal(size=3)), random_rot(rng)
        eq2 = rotate_plane_eq_around(eq, center, rot)
        d = signed_distance_to_plane(eq2, rotate_around(center, rot, pts))
        np.testing.assert_allclose(d.numpy(), 0.0, atol=1e-4)

    def test_translate_plane_eq_consistent_with_points(self, rng):
        eq = mk_plane_eq(t(rng.normal(size=3)), -0.4)
        pts = project_to_plane(eq, t(rng.normal(size=(20, 3))))
        off = t(rng.normal(size=3))
        d = signed_distance_to_plane(translate_plane_eq(eq, off), pts + off)
        np.testing.assert_allclose(d.numpy(), 0.0, atol=1e-4)

    def test_transform_plane_eq_full_proj(self, rng):
        eq = mk_plane_eq(t(rng.normal(size=3)), 0.9)
        pts = project_to_plane(eq, t(rng.normal(size=(20, 3))))
        rot = random_rot(rng)
        proj = compose_proj4(rotation_proj4_around(t(rng.normal(size=3)), rot),
                             proj4_from_translation(t(rng.normal(size=3))))
        d = signed_distance_to_plane(transform_plane_eq(eq, proj), apply_proj4(proj, pts))
        np.testing.assert_allclose(d.numpy(), 0.0, atol=1e-4)

    def test_batched_planes(self):
        eq = mk_plane_eq(t([[1.0, 0.0, 0.0], [0.0, 2.0, 0.0]]), t([1.0, 4.0]))
        assert tuple(eq.normal.shape) == (2, 3)
        np.testing.assert_allclose(eq.d.numpy(), [1.0, 2.0])


class TestPlaneCorner:
    def test_axis_planes_intersect_at_expected_point(self):
        ex = mk_plane_eq(t([1.0, 0.0, 0.0]), 1.0)
        ey = mk_plane_eq(t([0.0, 1.0, 0.0]), 2.0)
        ez = mk_plane_eq(t([0.0, 0.0, 1.0]), 3.0)
        corner, valid = plane_corner(ex, ey, ez)
        assert bool(valid)
        np.testing.assert_allclose(corner.numpy(), [1.0, 2.0, 3.0], atol=ATOL)

    def test_parallel_planes_flagged_invalid(self):
        e1 = mk_plane_eq(t([1.0, 0.0, 0.0]), 1.0)
        e2 = mk_plane_eq(t([1.0, 0.0, 0.0]), 2.0)
        e3 = mk_plane_eq(t([0.0, 1.0, 0.0]), 0.0)
        corner, valid = plane_corner(e1, e2, e3)  # a singular system, solved without raising
        assert not bool(valid)
        assert np.all(np.isnan(corner.numpy()))

    def test_batch_matches_single(self, rng):
        eqs = mk_plane_eq(t(rng.normal(size=(6, 3))), t(rng.normal(size=6)))
        triples = torch.tensor([[0, 1, 2], [3, 4, 5], [0, 2, 4]])
        pts, valid = plane_corners_batch(eqs, triples)
        assert tuple(pts.shape) == (3, 3)
        for k in range(3):
            i, j, m = (int(x) for x in triples[k])
            single, v = plane_corner(*(PlaneEq(eqs.normal[q], eqs.d[q]) for q in (i, j, m)))
            assert bool(v) == bool(valid[k])
            if bool(v):
                np.testing.assert_allclose(pts[k].numpy(), single.numpy(), atol=1e-4)


class TestFitPlane:
    def test_recovers_known_plane(self, rng):
        eq_true = mk_plane_eq(t(rng.normal(size=3)), 2.0)
        pts = project_to_plane(eq_true, t(rng.normal(size=(200, 3))) * 5)
        d = signed_distance_to_plane(fit_plane(pts), pts)
        np.testing.assert_allclose(d.numpy(), 0.0, atol=1e-3)

    def test_noisy_plane_normal_direction(self, rng):
        pts = np.concatenate(
            [rng.uniform(-3, 3, size=(500, 2)), 5.0 + 0.01 * rng.normal(size=(500, 1))], axis=1)
        eq = fit_plane(t(pts))
        np.testing.assert_allclose(np.abs(eq.normal.numpy()), [0.0, 0.0, 1.0], atol=0.01)
        assert float(eq.d) == pytest.approx(5.0, abs=0.01)

    def test_max_face_distance(self):
        eq = mk_plane_eq(t([0.0, 0.0, 1.0]), 1.0)
        assert float(max_face_distance(eq, t([[0, 0, 1.0], [1, 2, 0.5], [3, 1, 1.25]]))) == 0.5


class TestParity:
    """The same numpy inputs through the reference's functions: 1e-5."""

    @pytest.fixture(autouse=True)
    def _ref(self):
        pytest.importorskip("jax")

    def test_transforms_and_planes_match(self, rng):
        import jax.numpy as jnp

        from housescan_tpu.geometry import plane as JP
        from housescan_tpu.geometry import transform as JT

        for _ in range(5):
            q, axis = rng.normal(size=4), rng.normal(size=3)
            theta = rng.uniform(0, 2 * np.pi)
            c, pts = rng.normal(size=3), rng.normal(size=(30, 3))
            n1, n2 = rng.normal(size=3), rng.normal(size=3)
            normals, ds, off = rng.normal(size=(6, 3)), rng.normal(size=6), rng.normal(size=3)
            j = lambda x: jnp.asarray(x, jnp.float32)  # noqa: E731
            pairs = [
                (quat_rot_mat(t(q)), JT.quat_rot_mat(j(q))),
                (axis_angle_mat(t(axis), theta), JT.axis_angle_mat(j(axis), theta)),
                (rotation_between_normals(t(n1), t(n2)), JT.rotation_between_normals(j(n1), j(n2))),
                (rotate_around(t(c), quat_rot_mat(t(q)), t(pts)),
                 JT.rotate_around(j(c), JT.quat_rot_mat(j(q)), j(pts))),
                (rotation_proj4_around(t(c), quat_rot_mat(t(q))),
                 JT.rotation_proj4_around(j(c), JT.quat_rot_mat(j(q)))),
            ]
            eq, jeq = mk_plane_eq(t(normals), t(ds)), JP.mk_plane_eq(j(normals), j(ds))
            rot, jrot = quat_rot_mat(t(q)), JT.quat_rot_mat(j(q))
            for port, ref in (
                (eq, jeq),
                (rotate_plane_eq_around(eq, t(c), rot), JP.rotate_plane_eq_around(jeq, j(c), jrot)),
                (translate_plane_eq(eq, t(off)), JP.translate_plane_eq(jeq, j(off))),
                (transform_plane_eq(eq, rotation_proj4_around(t(c), rot)),
                 JP.transform_plane_eq(jeq, JT.rotation_proj4_around(j(c), jrot))),
            ):
                pairs += [(port.normal, ref.normal), (port.d, ref.d)]
            pairs += [
                (project_to_plane(PlaneEq(eq.normal[0], eq.d[0]), t(pts)),
                 JP.project_to_plane(JP.PlaneEq(jeq.normal[0], jeq.d[0]), j(pts))),
                (signed_distances_pairwise(eq, t(pts)), JP.signed_distances_pairwise(jeq, j(pts))),
            ]
            for port, ref in pairs:
                np.testing.assert_allclose(port.numpy(), np.asarray(ref), atol=1e-5, rtol=0)

    def test_fits_and_corners_match(self, rng):
        import jax.numpy as jnp

        from housescan_tpu.geometry import fitting as JF
        from housescan_tpu.geometry import plane as JP

        for _ in range(5):
            pts = np.concatenate([rng.uniform(-3, 3, (300, 2)),
                                  2.0 + 0.01 * rng.normal(size=(300, 1))], axis=1) @ \
                quat_rot_mat(t(rng.normal(size=4))).numpy().astype(np.float64)
            a, b = fit_plane(t(pts)), JF.fit_plane(jnp.asarray(pts, jnp.float32))
            np.testing.assert_allclose(a.normal.numpy(), np.asarray(b.normal), atol=1e-5)
            assert float(a.d) == pytest.approx(float(b.d), abs=1e-5)
        normals = rng.normal(size=(7, 3))
        normals[6] = normals[0]  # parallel to plane 0: invalid triples
        ds = rng.normal(size=7)
        triples = np.array([[i, j, k] for i in range(7) for j in range(i + 1, 7)
                            for k in range(j + 1, 7)], np.int32)
        pts, valid = plane_corners_batch(mk_plane_eq(t(normals), t(ds)), torch.from_numpy(triples))
        jpts, jvalid = JF.plane_corners_batch(
            JP.mk_plane_eq(jnp.asarray(normals, jnp.float32), jnp.asarray(ds, jnp.float32)),
            jnp.asarray(triples))
        np.testing.assert_array_equal(valid.numpy(), np.asarray(jvalid))
        assert (~valid).sum() >= 5
        np.testing.assert_allclose(pts.numpy(), np.asarray(jpts), atol=1e-5, rtol=1e-5)
