"""Parity of the port's foundations, preprocessing and map code with the
reference.

K1 (bilateral filter) against ``bilateral_filter_pallas`` in interpret
mode at the reference's own bound (atol 2e-5), at the 160x120 test frame
and at sizes no tile divides, radii 0, 1, 3, 5 and 7. The pyramid against the
reference's CPU path: depths within the same 2e-5; live maps within
1e-4, because a normal is a cross product of neighbour differences: a
last-bit depth difference (2.4e-7 at 2 m) over the 2-pixel stencil span
(~1.5 cm at 1 m on the 160-px camera) moves a component by ~1.6e-5. The
map pyramid (exact selection) bit for bit; the model gradients and the
ICP packing within 1e-6.
"""

import pytest

pytest.importorskip("jax")

import jax.numpy as jnp
import numpy as np
import torch

from housescan_tpu.kinfu import maps as jmaps
from housescan_tpu.kinfu.camera import Intrinsics as JIntrinsics
from housescan_tpu.kinfu.preprocess import build_pyramid as j_build_pyramid
from housescan_tpu.kinfu.synthetic import furnished_room, orbit_poses, render_depth_stream
from housescan_tpu.ops.preprocess_pallas import bilateral_filter_pallas
from housescan_tpu_torch.kinfu import maps
from housescan_tpu_torch.kinfu.camera import Intrinsics
from housescan_tpu_torch.kinfu.preprocess import bilateral_filter, build_pyramid
from housescan_tpu_torch.ops import cuda_lib
from housescan_tpu_torch.ops.preprocess_cuda import bilateral_filter_cuda
from housescan_tpu_torch.ops.pyramid_cuda import pyramid_cuda

JINTR = JIntrinsics(width=160, height=120, fx=131.25, fy=131.25, cx=79.5, cy=59.5)
INTR = Intrinsics(*JINTR)


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _depth(salted=True):
    half, boxes = furnished_room()
    poses = orbit_poses(2, radius=0.25, yaw_range=0.05, pitch=0.25)
    d = np.array(render_depth_stream(JINTR, poses, half, boxes=boxes)[0])
    if salted:
        d[40:50, 60:70] = 0.0  # invalid pixels
        d[:20, :] *= 2.0  # a hard edge
    return d


def _odd_depth(h, w):
    """An (h, w) crop of the salted frame, which no (8, 128) tile divides:
    the reference pads it with zeros (invalid), the port filters it as it
    is."""
    d = np.zeros((max(h, 120), max(w, 160)), np.float32)
    d[:120, :160] = _depth()
    return np.ascontiguousarray(d[:h, :w])


@pytest.mark.parametrize(
    "salted,hw,radius",
    [
        pytest.param(True, (120, 160), 3, id="True"),
        pytest.param(False, (120, 160), 3, id="False"),
        pytest.param(True, (121, 161), 0, id="161x121-r0"),
        pytest.param(True, (121, 161), 1, id="161x121-r1"),
        pytest.param(True, (57, 83), 5, id="83x57-r5"),
        pytest.param(True, (5, 7), 7, id="7x5-r7"),
    ],
)
def test_bilateral_matches_pallas(salted, hw, radius):
    d = _depth(salted) if hw == (120, 160) else _odd_depth(*hw)
    want = np.asarray(bilateral_filter_pallas(jnp.asarray(d), radius=radius, interpret=True))
    got = bilateral_filter_cuda(torch.from_numpy(d), radius).numpy()
    assert got.shape == want.shape == hw
    np.testing.assert_allclose(got, want, atol=2e-5)
    if salted and hw == (120, 160):
        assert (got[40:50, 60:70] == 0).all()
    assert (got[d == 0] == 0).all()


def test_bilateral_wrapper_uses_plain_on_cpu():
    d = torch.from_numpy(_depth())
    before = cuda_lib.plain_counts["bilateral"]
    np.testing.assert_array_equal(bilateral_filter_cuda(d).numpy(), bilateral_filter(d).numpy())
    assert cuda_lib.plain_counts["bilateral"] == before + 1


def test_pyramid_matches_reference():
    d = _depth()
    jp = j_build_pyramid(jnp.asarray(d), JINTR, levels=3)
    tp = build_pyramid(torch.from_numpy(d), INTR, levels=3)
    for lvl in range(3):
        np.testing.assert_allclose(tp.depths[lvl].numpy(), np.asarray(jp.depths[lvl]), atol=2e-5)
        np.testing.assert_allclose(tp.maps[lvl].numpy(), np.asarray(jp.maps[lvl]), atol=1e-4)
        live_valid_t = (tp.maps[lvl][3:6] ** 2).sum(0).numpy() > 0.25
        live_valid_j = (np.asarray(jp.maps[lvl])[3:6] ** 2).sum(0) > 0.25
        assert (live_valid_t == live_valid_j).mean() > 0.999


def test_pyramid_wrapper_uses_plain_on_cpu():
    """K11's wrapper takes its plain version for a CPU tensor (counted in
    ``plain_counts``, nothing launched), ``build_pyramid`` goes through it,
    and the result still holds to the reference's pyramid as above."""
    d = _depth()
    d0 = bilateral_filter_cuda(torch.from_numpy(d))
    before = dict(cuda_lib.plain_counts), dict(cuda_lib.launch_counts)
    depths, live = pyramid_cuda(d0, INTR, 3)
    assert cuda_lib.plain_counts["pyramid"] == before[0]["pyramid"] + 1
    assert cuda_lib.launch_counts == before[1]
    tp = build_pyramid(torch.from_numpy(d), INTR, levels=3)
    assert cuda_lib.plain_counts["pyramid"] == before[0]["pyramid"] + 2
    jp = j_build_pyramid(jnp.asarray(d), JINTR, levels=3)
    assert depths[0] is d0
    for lvl in range(3):
        assert live[lvl].shape == (6, 120 >> lvl, 160 >> lvl)
        assert torch.equal(tp.depths[lvl], depths[lvl]) and torch.equal(tp.maps[lvl], live[lvl])
        np.testing.assert_allclose(depths[lvl].numpy(), np.asarray(jp.depths[lvl]), atol=2e-5)
        np.testing.assert_allclose(live[lvl].numpy(), np.asarray(jp.maps[lvl]), atol=1e-4)


def test_map_code_matches_reference():
    rng = np.random.default_rng(0)
    model = rng.normal(size=(8, 60, 80)).astype(np.float32)
    model[7] = (rng.random((60, 80)) > 0.2).astype(np.float32)
    live = rng.normal(size=(6, 60, 80)).astype(np.float32)
    for a, b in zip(maps.build_map_pyramid(torch.from_numpy(model), 3),
                    jmaps.build_map_pyramid(jnp.asarray(model), 3)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    g_t = maps.model_gradients(torch.from_numpy(model))
    g_j = jmaps.model_gradients(jnp.asarray(model))
    np.testing.assert_allclose(g_t.numpy(), np.asarray(g_j), atol=1e-6)
    p_t = maps.pack_icp_inputs(torch.from_numpy(live), torch.from_numpy(model), g_t, band_h=32)
    p_j = jmaps.pack_icp_inputs(jnp.asarray(live), jnp.asarray(model), g_j, band_h=32)
    assert p_t.shape == (19, 64, 128)
    np.testing.assert_allclose(p_t.numpy(), np.asarray(p_j), atol=1e-6)


def test_geometry_and_camera_match_reference():
    """The foundations the step uses: rigid helpers (atol 1e-6, float32
    products in the same order), rays, projection and level intrinsics."""
    from housescan_tpu.geometry import transform as jt
    from housescan_tpu.kinfu.camera import pixel_rays as j_pixel_rays
    from housescan_tpu.kinfu.camera import project as j_project
    from housescan_tpu.kinfu.pipeline import inverse_rigid as j_inverse_rigid
    from housescan_tpu_torch.geometry import transform as tt
    from housescan_tpu_torch.kinfu.camera import pixel_rays, project

    rng = np.random.default_rng(0)
    axis = rng.normal(size=3).astype(np.float32)
    rot_t = tt.axis_angle_mat(torch.from_numpy(axis), 0.7)
    np.testing.assert_allclose(rot_t.numpy(), np.asarray(jt.axis_angle_mat(jnp.asarray(axis), 0.7)), atol=1e-6)
    pose = np.eye(4, dtype=np.float32)
    pose[:3, :3] = rot_t.numpy()
    pose[3, :3] = rng.normal(size=3)
    pts = rng.normal(size=(50, 3)).astype(np.float32)
    np.testing.assert_allclose(tt.inverse_rigid(torch.from_numpy(pose)).numpy(),
                               np.asarray(j_inverse_rigid(jnp.asarray(pose))), atol=1e-6)
    np.testing.assert_allclose(tt.apply_proj4(torch.from_numpy(pose), torch.from_numpy(pts)).numpy(),
                               np.asarray(jt.apply_proj4(jnp.asarray(pose), jnp.asarray(pts))), atol=1e-6)
    np.testing.assert_allclose(tt.compose_proj4(torch.from_numpy(pose), torch.from_numpy(pose)).numpy(),
                               np.asarray(jt.compose_proj4(jnp.asarray(pose), jnp.asarray(pose))), atol=1e-6)
    np.testing.assert_array_equal(pixel_rays(INTR).numpy(), np.asarray(j_pixel_rays(JINTR)))
    for got, want in zip(project(INTR, torch.from_numpy(pts)), j_project(JINTR, jnp.asarray(pts))):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert tuple(INTR.level(2)) == tuple(JINTR.level(2))


def test_packed_volume_layout_bit_identical():
    """pack/unpack and a fresh volume equal the reference's bit for bit,
    including ties, which both round half to even."""
    from housescan_tpu.kinfu import tsdf as jtsdf
    from housescan_tpu_torch.kinfu import tsdf

    rng = np.random.default_rng(1)
    t = rng.uniform(-1.2, 1.2, 4096).astype(np.float32)
    ties = (np.arange(-40, 40) + 0.5).astype(np.float32) / np.float32(32767.0)
    ties = ties[ties * np.float32(32767.0) == np.arange(-40, 40) + 0.5]
    assert ties.size > 10
    t = np.concatenate([t, ties, [-1.0, 0.0, 1.0]]).astype(np.float32)
    w = rng.integers(0, 129, t.size).astype(np.float32)
    got = tsdf.pack_tw(torch.from_numpy(t), torch.from_numpy(w)).numpy()
    want = np.asarray(jtsdf.pack_tw(jnp.asarray(t), jnp.asarray(w)))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(tsdf.unpack_t(torch.from_numpy(got)).numpy(),
                                  np.asarray(jtsdf.unpack_t(jnp.asarray(want))))
    np.testing.assert_array_equal(tsdf.unpack_w(torch.from_numpy(got)).numpy(), w)
    tv = tsdf.tsdf_new(128, 3.0, 0.06, dtype=torch.int32, device="cpu")
    jv = jtsdf.tsdf_new(128, 3.0, 0.06, dtype=jnp.int32)
    np.testing.assert_array_equal(tv.data.numpy(), np.asarray(jv.data))
    for a, b in ((tv.origin, jv.origin), (tv.voxel_size, jv.voxel_size), (tv.trunc, jv.trunc)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_default_volume_layout_matches_reference():
    """``tsdf_new`` with no dtype makes the reference's default volume: the
    float32 (2, X, Y, Z) array (+1 tsdf, 0 weight), equal value for value."""
    from housescan_tpu.kinfu import tsdf as jtsdf
    from housescan_tpu_torch.kinfu import tsdf

    tv = tsdf.tsdf_new(64, 3.0, 0.06, device="cpu")
    jv = jtsdf.tsdf_new(64, 3.0, 0.06)
    got, want = tv.data.numpy(), np.asarray(jv.data)
    assert got.shape == want.shape == (2, 64, 64, 64)
    assert got.dtype == want.dtype == np.float32
    assert not tv.packed_i32 and tv.dims == (64, 64, 64)
    np.testing.assert_array_equal(got, want)
    for a, b in ((tv.origin, jv.origin), (tv.voxel_size, jv.voxel_size), (tv.trunc, jv.trunc)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
