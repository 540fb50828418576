"""The port's XLA fusion path against the reference, module by module.

The XLA path is the step with ``use_pallas=False``: the dense integrate,
trilinear samples, the TSDF ray marcher, the XLA ICP loop and its
standalone solve (K2). Inputs: the furnished-room orbit at 160x120
(``orbit_poses(10, radius=0.25, yaw_range=pi/16, pitch=0.25)``, the
reference's own test stream), rendered by the port's synthetic module
and handed to both packages as numpy arrays; volumes of 96^3 (a
resolution that does not tile into 128-voxel chunks) over 3 m, trunc
0.06. The reference runs on the CPU as its tests run it: the XLA
functions directly, K2 through ``solve_twist_compose(interpret=True)``.

Tolerances, and why:

  * integrate: weights identical; tsdf within 1e-5 on the float layout.
    XLA contracts multiply-adds on the CPU where the port rounds twice,
    so the camera-frame z and the sampled depth (values <= 3 m) differ
    by a few ulp (~2.4e-7 m each), ~4e-6 after the division by the 0.06
    m trunc (measured 4.0e-6). On the packed layout the same difference
    can move the rounding of ``t * 32767`` by one step: within one
    quantization step, 1/32767 (measured exactly one step).
  * sample_trilinear / tsdf_gradient on one carried volume: masks equal,
    values within 1e-6 (the same float32 operations; measured 0).
  * raycast on one carried volume: valid masks agree on >= 99.5% of
    pixels (a crossing can move by one nearest-sample step where a sample
    sits within rounding of 0; measured 100%); where both are valid depth
    and vertices within 1e-5 m (measured 4.8e-7), normals within 2e-4
    (cross products of ulp-perturbed vertex differences over one pixel's
    ~2 cm; measured 4.0e-5).
  * normal equations: A and b within 1e-5 of their largest entry (float32
    sums of ~2e4 terms in another order; measured 1e-8 and 6e-7), the
    same correspondence count; level iterations: pose within 1e-5
    (K2's plain version against the reference's CPU ``jnp.linalg.solve``
    branch, which the reference holds to 2e-5; measured 3e-8).
  * K2's plain version against the reference kernel in interpret mode:
    2e-5, the reference's bound; degenerate systems keep the pose exactly;
    A, b and the pose stored apart (views into larger buffers, strided,
    float64) give the same bits as contiguous float32 copies.
"""

import pytest

pytest.importorskip("jax")

import jax.numpy as jnp
import numpy as np
import torch

from housescan_tpu.kinfu import icp as j_icp
from housescan_tpu.kinfu import maps as j_maps
from housescan_tpu.kinfu import tsdf as j_tsdf
from housescan_tpu.kinfu.camera import Intrinsics as JIntrinsics
from housescan_tpu.kinfu.preprocess import depth_to_vertices as j_depth_to_vertices
from housescan_tpu.kinfu.preprocess import vertex_normals as j_vertex_normals
from housescan_tpu.kinfu.raycast import raycast as j_raycast
from housescan_tpu.ops.solve6_pallas import solve_twist_compose as j_solve_twist_compose
from housescan_tpu_torch.geometry.transform import axis_angle_mat
from housescan_tpu_torch.kinfu import icp, tsdf
from housescan_tpu_torch.kinfu import maps as mp
from housescan_tpu_torch.kinfu.camera import Intrinsics
from housescan_tpu_torch.kinfu.preprocess import depth_to_vertices, vertex_normals
from housescan_tpu_torch.kinfu.raycast import raycast
from housescan_tpu_torch.kinfu.synthetic import furnished_room, orbit_poses, render_depth_stream
from housescan_tpu_torch.ops import cuda_lib
from housescan_tpu_torch.ops.solve6 import solve_twist_compose

INTR = Intrinsics(width=160, height=120, fx=131.25, fy=131.25, cx=79.5, cy=59.5)
JINTR = JIntrinsics(*INTR)
RES = 96
TRUNC = 0.06


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def stream():
    half, boxes = furnished_room()
    poses = np.array(orbit_poses(10, radius=0.25, yaw_range=np.pi / 16, pitch=0.25))
    frames = render_depth_stream(INTR, poses, half, boxes, device="cpu").numpy()
    return poses, frames


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def carried(stream):
    """The reference's float volume after frames 0-1, in both packages."""
    poses, frames = stream
    jv = j_tsdf.tsdf_new(RES, 3.0, TRUNC)
    for i in range(2):
        jv = j_tsdf.tsdf_integrate(jv, jnp.asarray(frames[i]), jnp.asarray(poses[i]), JINTR)
    fields = [np.array(getattr(jv, k)) for k in tsdf.TsdfVolume._fields]
    return j_tsdf.TsdfVolume(*(jnp.asarray(f) for f in fields)), tsdf.TsdfVolume(*map(_t, fields))


# --- the dense integrate ---------------------------------------------------


@pytest.mark.parametrize("interp", ["bilinear", "nearest"])
@pytest.mark.parametrize("layout", ["float", "packed"])
def test_integrate_matches_reference(stream, layout, interp):
    poses, frames = stream
    jdt, tdt = (jnp.float32, torch.float32) if layout == "float" else (jnp.int32, torch.int32)
    jv = j_tsdf.tsdf_new(RES, 3.0, TRUNC, dtype=jdt)
    tv = tsdf.tsdf_new(RES, 3.0, TRUNC, dtype=tdt, device="cpu")
    for i in range(3):
        jv = j_tsdf.tsdf_integrate(jv, jnp.asarray(frames[i]), jnp.asarray(poses[i]), JINTR,
                                   depth_interp=interp)
        assert tsdf.tsdf_integrate(tv, _t(frames[i]), _t(poses[i]), INTR, depth_interp=interp) is tv
    assert tv.data.dtype == tdt and tv.dims == (RES,) * 3
    w_ref = np.asarray(jv.weight)
    assert (w_ref > 0).sum() > 10000 and w_ref.max() == 3.0
    np.testing.assert_array_equal(tv.weight.numpy(), w_ref)
    tol = 1e-5 if layout == "float" else 1.0 / 32767 + 1e-7
    np.testing.assert_allclose(tv.tsdf.numpy(), np.asarray(jv.tsdf), atol=tol, rtol=0)


def test_integrate_slabs_bit_identical_to_one_pass(stream, monkeypatch):
    """The x-slab sweep (here 7 slices a pass, the last one short) gives
    the one-pass volume bit for bit, in both layouts."""
    poses, frames = stream
    for dtype in (torch.float32, torch.int32):
        one = tsdf.tsdf_new(RES, 3.0, TRUNC, dtype=dtype, device="cpu")
        tsdf.tsdf_integrate(one, _t(frames[0]), _t(poses[0]), INTR)
        monkeypatch.setattr(tsdf, "INTEGRATE_SLAB_VOXELS", 7 * RES * RES)
        sl = tsdf.tsdf_new(RES, 3.0, TRUNC, dtype=dtype, device="cpu")
        tsdf.tsdf_integrate(sl, _t(frames[0]), _t(poses[0]), INTR)
        monkeypatch.undo()
        assert torch.equal(one.data, sl.data)


def test_volume_layouts_and_config(stream):
    """Both layouts read alike through the properties; ``from_config``
    picks the layout by name, bfloat16 included."""
    from housescan_tpu_torch.config import TsdfConfig

    poses, frames = stream
    fv = tsdf.tsdf_new(64, 3.0, TRUNC, dtype=torch.float32, device="cpu")
    pv = tsdf.tsdf_new(64, 3.0, TRUNC, dtype=torch.int32, device="cpu")
    jf = j_tsdf.tsdf_new(64, 3.0, TRUNC)
    np.testing.assert_array_equal(fv.data.numpy(), np.asarray(jf.data))
    assert fv.data.shape == (2, 64, 64, 64) and not fv.packed_i32 and pv.packed_i32
    assert fv.dims == pv.dims == (64, 64, 64)
    for v in (fv, pv):
        tsdf.tsdf_integrate(v, _t(frames[0]), _t(poses[0]), INTR)
    np.testing.assert_array_equal(fv.weight.numpy(), pv.weight.numpy())
    assert np.abs(fv.tsdf.numpy() - pv.tsdf.numpy()).max() <= 0.5 / 32767 + 1e-7
    again = pv.replace_grids(tsdf=pv.tsdf)
    assert torch.equal(again.data, pv.data)
    made = tsdf.make_volume(fv.tsdf, fv.weight, fv.origin, fv.voxel_size, fv.trunc)
    assert torch.equal(made.data, fv.data)
    cfg = TsdfConfig(resolution=64, size_m=3.0, trunc_dist=TRUNC)
    assert tsdf.from_config(cfg, device="cpu").data.dtype == torch.float32
    assert tsdf.from_config(TsdfConfig(resolution=64, dtype="packed_i16"), device="cpu").packed_i32
    bf = tsdf.from_config(TsdfConfig(resolution=64, dtype="bfloat16"), device="cpu")
    assert bf.data.dtype == torch.bfloat16 and bf.data.shape == (2, 64, 64, 64)


# --- samples and the ray marcher -------------------------------------------


def test_trilinear_and_gradient_match_reference(carried):
    jv, tv = carried
    rng = np.random.default_rng(0)
    pts = rng.uniform(-1.45, 1.45, (20000, 3)).astype(np.float32)
    for support in (0.25, 0.95):
        jval, jok = j_tsdf.sample_trilinear(jv, jnp.asarray(pts), min_support=support)
        tval, tok = tsdf.sample_trilinear(tv, _t(pts), min_support=support)
        jok = np.asarray(jok)
        assert jok.sum() > 300
        np.testing.assert_array_equal(tok.numpy(), jok)
        np.testing.assert_allclose(tval.numpy()[jok], np.asarray(jval)[jok], atol=1e-6)
    jg = np.asarray(j_tsdf.tsdf_gradient(jv, jnp.asarray(pts)))
    tg = tsdf.tsdf_gradient(tv, _t(pts)).numpy()
    np.testing.assert_allclose(tg, jg, atol=1e-6)


def test_raycast_matches_reference(stream, carried):
    poses, _ = stream
    jv, tv = carried
    jr = j_raycast(jv, jnp.asarray(poses[1]), JINTR)
    tr = raycast(tv, _t(poses[1]), INTR)
    jvalid = np.asarray(jr.valid)
    tvalid = tr.valid.numpy()
    assert jvalid.mean() > 0.7
    assert (jvalid == tvalid).mean() >= 0.995
    both = jvalid & tvalid
    np.testing.assert_allclose(tr.depth.numpy()[both], np.asarray(jr.depth)[both], atol=1e-5)
    np.testing.assert_allclose(tr.vertices.numpy()[both], np.asarray(jr.vertices)[both], atol=1e-5)
    np.testing.assert_allclose(tr.normals.numpy()[both], np.asarray(jr.normals)[both], atol=2e-4)
    for rows in (tr.depth, tr.vertices, tr.normals):
        assert bool((rows.numpy()[~tvalid] == 0).all())
    packed = mp.model_from_hwc(tr.vertices, tr.normals, tr.valid, tr.depth)
    want = j_maps.model_from_hwc(jr.vertices, jr.normals, jr.valid, jr.depth)
    assert packed.shape == want.shape == (8, 120, 160)


def test_raycast_depth_parity(stream):
    """Twin of the reference's ``TestRaycast.test_depth_parity``: one
    frame fused at 128^3, the ray marcher's depth within 5 mm p95 of the
    rendered depth on flat pixels, > 70% of the image valid."""
    poses, frames = stream
    vol = tsdf.tsdf_new(128, 3.0, TRUNC, dtype=torch.float32, device="cpu")
    tsdf.tsdf_integrate(vol, _t(frames[0]), _t(poses[0]), INTR)
    rc = raycast(vol, _t(poses[0]), INTR)
    valid = rc.valid.numpy()
    assert valid.mean() > 0.7
    n0 = vertex_normals(depth_to_vertices(_t(frames[0]), INTR)).numpy()
    m = valid & (np.linalg.norm(n0, axis=-1) > 0.5) & (frames[0] > 0)
    err = np.abs(rc.depth.numpy()[m] - frames[0][m])
    assert np.quantile(err, 0.95) < 0.005


def test_raycast_empty_volume_no_hits():
    """Twin of ``TestRaycast.test_empty_volume_no_hits``."""
    for dtype in (torch.float32, torch.int32):
        vol = tsdf.tsdf_new(64, 3.0, TRUNC, dtype=dtype, device="cpu")
        assert not bool(raycast(vol, torch.eye(4), INTR).valid.any())


# --- maps and normals ------------------------------------------------------


def test_vertex_normals_and_hwc_maps_match_reference(stream):
    _, frames = stream
    jv = j_depth_to_vertices(jnp.asarray(frames[3]), JINTR)
    jn = np.asarray(j_vertex_normals(jv))
    tn = vertex_normals(depth_to_vertices(_t(frames[3]), INTR)).numpy()
    assert (np.linalg.norm(jn, axis=-1) > 0.5).mean() > 0.8
    np.testing.assert_allclose(tn, jn, atol=1e-6)
    rng = np.random.default_rng(2)
    model = rng.normal(size=(8, 30, 40)).astype(np.float32)
    model[7] = (rng.random((30, 40)) > 0.3).astype(np.float32)
    live = rng.normal(size=(6, 30, 40)).astype(np.float32)
    for got, want in zip(mp.model_to_hwc(_t(model)), j_maps.model_to_hwc(jnp.asarray(model))):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for got, want in zip(mp.live_to_hwc(_t(live)), j_maps.live_to_hwc(jnp.asarray(live))):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(mp.model_from_hwc(*mp.model_to_hwc(_t(model))).numpy(),
                                  np.where(np.arange(8)[:, None, None] == 7, model[7] > 0.5, model))
    np.testing.assert_array_equal(mp.live_from_hwc(*mp.live_to_hwc(_t(live))).numpy(), live)


# --- the XLA ICP loop ------------------------------------------------------


def _icp_inputs(stream, live_frame=1):
    """Frame 0 as the model (its own vertex map at its pose), another
    frame as the live view: (h, w, 3) maps in both packages."""
    poses, frames = stream
    p0 = jnp.asarray(poses[0])
    v0 = j_depth_to_vertices(jnp.asarray(frames[0]), JINTR)
    n0 = j_vertex_normals(v0)
    mv = v0 @ p0[:3, :3] + p0[3, :3]
    mn = n0 @ p0[:3, :3]
    mok = (v0[..., 2] > 0) & (jnp.linalg.norm(n0, axis=-1) > 0.5)
    v1 = j_depth_to_vertices(jnp.asarray(frames[live_frame]), JINTR)
    n1 = j_vertex_normals(v1)
    j_in = (v1, n1, mv, mn, mok, j_icp._model_gradients(mv, mok))
    t_in = tuple(_t(a) for a in (v1, n1, mv, mn, mok))
    t_in = t_in + (icp._model_gradients(t_in[2], t_in[4]),)
    for got, want in zip(t_in[5], j_in[5]):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    return p0, j_in, t_in


def test_normal_equations_match_reference(stream):
    p0, j_in, t_in = _icp_inputs(stream)
    ja, jb, jn, jsq = j_icp._normal_equations(p0, *j_in, p0, JINTR, 0.10, 0.5236, window=4)
    ta, tb, tn, tsq = icp._normal_equations(_t(p0), *t_in, _t(p0), INTR, 0.10, 0.5236, window=4)
    ja, jb = np.asarray(ja), np.asarray(jb)
    assert int(jn) > 10000 and tn.dtype == torch.int32
    assert int(tn) == int(jn)
    np.testing.assert_allclose(ta.numpy(), ja, atol=1e-5 * np.abs(ja).max(), rtol=0)
    np.testing.assert_allclose(tb.numpy(), jb, atol=1e-5 * np.abs(jb).max(), rtol=0)
    assert abs(float(tsq) - float(jsq)) <= 1e-5 * float(jsq)


def test_level_iterations_match_reference(stream):
    """Six iterations from the model pose (window 4): each iteration's
    pose within 1e-5 of the reference's CPU branch, the same counts, and
    K2's plain version ran once an iteration."""
    p0, j_in, t_in = _icp_inputs(stream)
    jp, tp = p0, _t(p0)
    cuda_lib.reset_counts()
    for _ in range(6):
        jp, jrm, jnc, jst = j_icp._icp_level_iteration(jp, *j_in, p0, JINTR, 0.10, 0.5236, window=4)
        tp, trm, tnc, tst = icp._icp_level_iteration(tp, *t_in, _t(p0), INTR, 0.10, 0.5236, window=4)
        np.testing.assert_allclose(tp.numpy(), np.asarray(jp), atol=1e-5)
        assert int(tnc) == int(jnc)
        assert abs(float(trm) - float(jrm)) <= 1e-6
        assert abs(float(tst) - float(jst)) <= 1e-5
    assert cuda_lib.plain_counts["solve6"] == 6 and cuda_lib.launch_counts["solve6"] == 0


def test_exact_maps_converge_to_zero(stream):
    """Twin of ``TestIcp.test_exact_maps_converge_to_zero``: six
    iterations on exact maps land within 0.5 mm of frame 1's pose."""
    poses, _ = stream
    p0, _, t_in = _icp_inputs(stream)
    pose = _t(p0)
    for _ in range(6):
        pose, rmse, ncorr, _ = icp._icp_level_iteration(pose, *t_in, _t(p0), INTR, 0.10, 0.5236,
                                                        window=4)
    assert float(np.linalg.norm(pose.numpy()[3, :3] - poses[1][3, :3])) < 5e-4
    assert int(ncorr) > 5000


def test_recovers_perturbed_start(stream):
    """Twin of ``TestIcp.test_recovers_perturbed_start``: live = frame 0
    itself, the start 10 mm and 0.01 rad away; back within 1 mm."""
    poses, _ = stream
    p0, _, t_in = _icp_inputs(stream, live_frame=0)
    bad = np.array(poses[0])
    bad[3, :3] += [0.002, -0.006, 0.010]
    bad[:3, :3] = bad[:3, :3] @ axis_angle_mat(torch.tensor([0.0, 1.0, 0.0]), 0.01).numpy()
    pose = _t(bad)
    for _ in range(10):
        pose, _, _, _ = icp._icp_level_iteration(pose, *t_in, _t(p0), INTR, 0.10, 0.5236)
    assert float(np.linalg.norm(pose.numpy()[3, :3] - poses[0][3, :3])) < 1e-3


# --- K2 --------------------------------------------------------------------


def test_solve_matches_reference_kernel():
    """Twin of ``TestSolveTwistPallas.test_matches_xla_reference``: K2's
    plain version (the wrapper on CPU tensors) against the reference's
    kernel in interpret mode on random SPD systems, 2e-5."""
    rng = np.random.default_rng(3)
    cuda_lib.reset_counts()
    for _ in range(10):
        g = rng.normal(size=(50, 6))
        a = (g.T @ g).astype(np.float32)
        b = (rng.normal(size=6) * 0.1).astype(np.float32)
        pose = np.eye(4, dtype=np.float32)
        pose[3, :3] = rng.normal(size=3)
        want, want_norm = j_solve_twist_compose(jnp.asarray(pose), jnp.asarray(a), jnp.asarray(b),
                                                damping=3e-4, interpret=True)
        got, got_norm = solve_twist_compose(_t(pose), _t(a), _t(b), damping=3e-4)
        assert got.shape == (4, 4) and got_norm.shape == ()
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)
        assert abs(float(got_norm) - float(want_norm)) <= 2e-5
    assert cuda_lib.plain_counts["solve6"] == 10 and cuda_lib.launch_counts["solve6"] == 0


@pytest.mark.parametrize("case", ["zero_a", "nan_a", "nan_b"])
def test_solve_degenerate_system_keeps_pose(case):
    """Twin of ``TestSolveTwistPallas.test_degenerate_system_keeps_pose``:
    the pose stays exactly unchanged and the step norm is ~0, in the port
    as in the reference kernel."""
    pose = np.eye(4, dtype=np.float32)
    pose[3, :3] = [0.3, -0.1, 1.7]
    a = {"zero_a": np.zeros((6, 6)), "nan_a": np.full((6, 6), np.nan), "nan_b": np.eye(6)}[case]
    b = np.full(6, np.nan) if case == "nan_b" else np.ones(6)
    a, b = a.astype(np.float32), b.astype(np.float32)
    got, norm = solve_twist_compose(_t(pose), _t(a), _t(b))
    want, want_norm = j_solve_twist_compose(jnp.asarray(pose), jnp.asarray(a), jnp.asarray(b),
                                            interpret=True)
    np.testing.assert_array_equal(got.numpy(), pose)
    np.testing.assert_array_equal(np.asarray(want), pose)
    assert float(norm) <= 1e-9 and float(want_norm) <= 1e-9


@pytest.mark.parametrize("storage", ["views", "float64"])
def test_solve_on_separately_stored_inputs_matches_reference(storage):
    """``solve_twist_compose`` on A, b and the pose stored apart, as the
    XLA loop hands them over (K2 reads each where it lies): strided views
    into larger buffers, or float64 tensors; against the reference kernel
    in interpret mode (2e-5), and bit-equal to the call on contiguous
    float32 copies."""
    rng = np.random.default_rng(9)
    for _ in range(4):
        g = rng.normal(size=(50, 6))
        a = (g.T @ g).astype(np.float32)
        b = (rng.normal(size=6) * 0.1).astype(np.float32)
        pose = np.eye(4, dtype=np.float32)
        pose[3, :3] = rng.normal(size=3)
        if storage == "views":
            a_t = torch.zeros(6, 12)
            a_t[:, ::2] = _t(a)
            b_t = torch.zeros(6, 3)
            b_t[:, 1] = _t(b)
            p_t = torch.zeros(4, 4, 2)
            p_t[:, :, 0] = _t(pose)
            args = (p_t[:, :, 0], a_t[:, ::2], b_t[:, 1])
            assert not any(x.is_contiguous() for x in args)
        else:
            args = (_t(pose).double(), _t(a).double(), _t(b).double())
        got, got_norm = solve_twist_compose(*args, damping=3e-4)
        ref, ref_norm = solve_twist_compose(_t(pose), _t(a), _t(b), damping=3e-4)
        want, want_norm = j_solve_twist_compose(jnp.asarray(pose), jnp.asarray(a), jnp.asarray(b),
                                                damping=3e-4, interpret=True)
        assert torch.equal(got, ref) and torch.equal(got_norm, ref_norm)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)
        assert abs(float(got_norm) - float(want_norm)) <= 2e-5
