"""Parity of the port's dense column integrate (K8) with the reference.

Two frames of the furnished-room orbit (160x120) go through the
reference's ``tsdf_integrate_with_planes`` (Pallas in interpret mode, as
its own tests run it) and through the port's, on the CPU (its plain
version), from the same fresh 128^3 float32 volume; the second frame
lands on the first. One more case fuses frame 0 into the packed layout.
Tolerances:

  * weights: identical (integer counts; the classifier and the update
    predicates are the reference's, operation for operation);
  * tsdf: within 1e-5 where observed. The reference contracts the
    bilinear window with an XLA dot, which may fuse the two-term sums
    into multiply-adds where the port rounds each product: the depth may
    move by one ulp (2.4e-7 m at 2 m), the sample by that over the 0.06 m
    truncation, 4e-6;
  * planes: valid flags on >= 99.9% of sub-blocks; where both are valid,
    fields 0-3 (normal, offset) and 12 (lambda_min) within 1e-4, the rest
    within 1e-5: the bounds of ``tests/test_torch_integrate.py`` (the
    reference sums the crossing moments in float32, the port in float64);
    lanes past R/8 zero in both;
  * packed: weights identical, the tsdf within one quantization step
    (1/32767) on >= 99.9% of observed voxels, the same plane bounds.

A wall frame (constant depth, the camera 3 m before the cube's centre
looking along +z, the wall at the centre) goes through both at R = 128 and
256 with the same bounds: at 256 the wall lies on the boundary between
the column's two chunks, so its planes come only from the +z crossing
into the next chunk, read after that chunk's integrate.
"""

import pytest

pytest.importorskip("jax")

import jax.numpy as jnp
import numpy as np
import torch

from housescan_tpu.kinfu.camera import Intrinsics as JIntrinsics
from housescan_tpu.kinfu.synthetic import furnished_room, orbit_poses, render_depth_stream
from housescan_tpu.kinfu.tsdf import tsdf_new as j_tsdf_new
from housescan_tpu.ops.tsdf_pallas import tsdf_integrate_with_planes as j_integrate
from housescan_tpu_torch.kinfu.camera import Intrinsics
from housescan_tpu_torch.kinfu.tsdf import tsdf_new
from housescan_tpu_torch.ops import cuda_lib
from housescan_tpu_torch.ops import tsdf_cuda
from housescan_tpu_torch.ops.tsdf_cuda import (
    dense_inputs,
    dense_integrate_plain,
    launch_dense_kernel,
    tsdf_integrate_pallas,
    tsdf_integrate_with_planes,
)

JINTR = JIntrinsics(width=160, height=120, fx=131.25, fy=131.25, cx=79.5, cy=59.5)
INTR = Intrinsics(*JINTR)
RES = 128
TRUNC = 0.06


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _scene():
    half, boxes = furnished_room()
    poses = orbit_poses(2, radius=0.25, yaw_range=0.05, pitch=0.25)
    frames = render_depth_stream(JINTR, poses, half, boxes=boxes)
    return np.asarray(frames), np.asarray(poses)


def _run(j_dtype, t_dtype, n_frames):
    """Both packages over ``n_frames`` frames from a fresh volume: per
    frame, (reference tsdf, weight, planes, port tsdf, weight, planes)."""
    torch.set_num_threads(1)
    frames, poses = _scene()
    jv = j_tsdf_new(RES, 3.0, TRUNC, dtype=j_dtype)
    tv = tsdf_new(RES, 3.0, TRUNC, dtype=t_dtype, device="cpu")
    out = []
    for i in range(n_frames):
        d, p = frames[i], poses[i]
        jv, jp = j_integrate(jv, jnp.asarray(d), jnp.asarray(p), JINTR, interpret=True)
        j = (np.array(jv.tsdf), np.array(jv.weight), np.array(jp))
        tv, tp = tsdf_integrate_with_planes(tv, torch.from_numpy(d), torch.from_numpy(p), INTR)
        out.append(j + (tv.tsdf.numpy().copy(), tv.weight.numpy().copy(), tp.numpy()))
    return out, tv


@pytest.fixture(scope="module")
def runs():
    cuda_lib.reset_counts()
    out, tv = _run(jnp.float32, torch.float32, 2)
    return dict(frames=out, vol=tv, counts=(dict(cuda_lib.launch_counts),
                                            dict(cuda_lib.plain_counts)))


@pytest.fixture(scope="module")
def packed():
    out, tv = _run(jnp.int32, torch.int32, 1)
    return dict(frames=out, vol=tv)


def _planes_agree(jp, tp, res=RES):
    jv, tv = jp[:, :, 4] > 0.5, tp[:, :, 4] > 0.5
    assert jv.sum() > 30
    assert (jv == tv).mean() >= 0.999
    both = jv & tv
    for f in range(16):
        atol = 1e-4 if f in (0, 1, 2, 3, 12) else 1e-5
        np.testing.assert_allclose(tp[:, :, f][both], jp[:, :, f][both], atol=atol)
    nsub = res // 8
    assert not tp[:, :, :, nsub:].any() and not jp[:, :, :, nsub:].any()


@pytest.mark.parametrize("frame", [0, 1])
def test_weights_identical(runs, frame):
    jt, jw, jp, tt, tw, tp = runs["frames"][frame]
    np.testing.assert_array_equal(tw, jw)
    assert (jw > 0).sum() > 10000


@pytest.mark.parametrize("frame", [0, 1])
def test_tsdf_within_bound_where_observed(runs, frame):
    jt, jw, jp, tt, tw, tp = runs["frames"][frame]
    obs = jw > 0
    assert np.abs(tt - jt)[obs].max() <= 1e-5


@pytest.mark.parametrize("frame", [0, 1])
def test_planes_agree(runs, frame):
    jt, jw, jp, tt, tw, tp = runs["frames"][frame]
    _planes_agree(jp, tp)


def test_unobserved_voxels_untouched(runs):
    jt, jw, jp, tt, tw, tp = runs["frames"][1]
    free = jw == 0
    assert free.sum() > 0
    assert (tt[free] == 1.0).all() and (jt[free] == 1.0).all()


def test_two_frame_accumulation(runs):
    """Twin of the reference's ``test_two_frame_accumulation``."""
    assert float(runs["vol"].weight.max()) == 2.0


def test_packed_layout_matches_reference(packed):
    """The packed volume is decoded, fused and re-packed; the planes come
    from the unrounded values."""
    jt, jw, jp, tt, tw, tp = packed["frames"][0]
    np.testing.assert_array_equal(tw, jw)
    obs = jw > 0
    steps = np.abs(np.round(tt * 32767).astype(np.int64) - np.round(jt * 32767).astype(np.int64))
    assert (steps[obs] <= 1).mean() >= 0.999
    _planes_agree(jp, tp)
    assert packed["vol"].data.dtype == torch.int32


def test_rejects_untileable_volume():
    """Twin of the reference's ``test_rejects_untileable_volume``."""
    with pytest.raises(ValueError):
        tsdf_integrate_pallas(tsdf_new(96, 3.0, TRUNC, dtype=torch.float32, device="cpu"),
                              torch.zeros(120, 160), torch.eye(4), INTR)


def test_cpu_runs_plain_version_only(runs):
    launched, plain = runs["counts"]
    assert plain["tsdf_dense"] == 2 and launched["tsdf_dense"] == 0


def test_kernel_wrapper_refuses_cpu_tensors():
    """The CUDA wrapper launches on CUDA tensors or raises; it never falls
    back to the plain version."""
    vol = tsdf_new(RES, 3.0, TRUNC, dtype=torch.float32, device="cpu")
    mips, params = dense_inputs(vol, torch.zeros(120, 160), torch.eye(4), INTR)
    with pytest.raises(ValueError):
        launch_dense_kernel(vol.data, mips, params)


def test_exported_from_ops():
    """``tsdf_integrate_pallas`` is exported by the ops package, as the
    reference's ``ops/__init__.py`` exports it."""
    from housescan_tpu_torch import ops

    assert ops.tsdf_integrate_pallas is tsdf_integrate_pallas


def _wall(res, depth_m=3.0):
    """The camera 3 m before the cube's centre looking along +z and a
    constant-depth frame: (reference volume, planes, port volume, planes)
    from fresh float32 volumes of resolution ``res``."""
    pose = np.eye(4, dtype=np.float32)
    pose[3, 2] = -3.0
    depth = np.full((120, 160), depth_m, np.float32)
    jv, jp = j_integrate(j_tsdf_new(res, 3.0, TRUNC, dtype=jnp.float32), jnp.asarray(depth),
                         jnp.asarray(pose), JINTR, interpret=True)
    tv, tp = tsdf_integrate_with_planes(tsdf_new(res, 3.0, TRUNC, dtype=torch.float32, device="cpu"),
                                        torch.from_numpy(depth), torch.from_numpy(pose), INTR)
    return jv, np.asarray(jp), tv, tp.numpy()


@pytest.mark.parametrize("res", [128, 256])
def test_wall_on_chunk_boundary_matches_reference(res):
    """The wall between voxels R/2 - 1 and R/2: weights identical, tsdf
    within 1e-5, the planes agree, and every valid plane lies in
    sub-block R/16 - 1 (at R = 256 the last of chunk 0, fitted only from
    the crossing into chunk 1)."""
    torch.set_num_threads(1)
    jv, jp, tv, tp = _wall(res)
    jw, tw = np.asarray(jv.weight), tv.weight.numpy()
    np.testing.assert_array_equal(tw, jw)
    obs = jw > 0
    assert obs.sum() > 10000
    assert np.abs(tv.tsdf.numpy() - np.asarray(jv.tsdf))[obs].max() <= 1e-5
    _planes_agree(jp, tp, res)
    valid = (tp[:, :, 4] > 0.5).sum(axis=(0, 1))
    lane = res // 16 - 1
    assert valid[lane] > 100 and valid.sum() == valid[lane]
    assert ((jp[:, :, 4] > 0.5).sum(axis=(0, 1)) == valid).all()


@pytest.mark.parametrize("res", [128, 256])
def test_plain_planes_zero_past_the_column(res):
    """The plain version writes exactly zero into every lane past R/8 of
    each column's planes tile (the kernel writes them itself)."""
    vol = tsdf_new(res, 3.0, TRUNC, dtype=torch.float32, device="cpu")
    pose = torch.eye(4)
    pose[3, 2] = -3.0
    mips, params = dense_inputs(vol, torch.full((120, 160), 3.0), pose, INTR)
    _, planes = dense_integrate_plain(vol.data, mips, params)
    assert tuple(planes.shape) == (res // 8, res // 8, 16, 128)
    assert int((planes[:, :, 4, : res // 8] > 0.5).sum()) > 100
    assert torch.equal(planes[:, :, :, res // 8 :], torch.zeros_like(planes[:, :, :, res // 8 :]))


def test_kernel_wrapper_allocates_planes_without_fill(monkeypatch):
    """``launch_dense_kernel`` hands the kernel an unfilled planes tensor
    (the kernel writes every lane) and its persistent grid: no
    ``torch.zeros`` / ``torch.full`` / ``fill_`` in the launch. The CUDA
    checks and the library are stubbed so the wrapper runs on the CPU."""
    vol = tsdf_new(RES, 3.0, TRUNC, dtype=torch.float32, device="cpu")
    mips, params = dense_inputs(vol, torch.zeros(120, 160), torch.eye(4), INTR)
    seen = {}

    class Lib:
        def hs_tsdf_dense(self, *args):
            seen["planes_ptr"], seen["grid"] = args[-4], args[-2]
            return 0

    def no_fill(*args, **kwargs):
        raise AssertionError("the planes were filled on the host side of the launch")

    monkeypatch.setattr(cuda_lib, "require_cuda", lambda *a, **k: None)
    monkeypatch.setattr(cuda_lib, "launch", lambda fn, device, *args: getattr(Lib(), fn)(*args, 0))
    monkeypatch.setattr(tsdf_cuda, "_card", lambda kernel, key, device: (1, 132))
    monkeypatch.setattr(torch, "zeros", no_fill)
    monkeypatch.setattr(torch, "full", no_fill)
    monkeypatch.setattr(torch.Tensor, "fill_", no_fill)
    monkeypatch.setattr(torch.Tensor, "zero_", no_fill)
    cls, planes = launch_dense_kernel(vol.data, mips, params)
    assert tuple(planes.shape) == (RES // 8, RES // 8, 16, 128)
    assert seen["planes_ptr"] == planes.data_ptr()
    assert seen["grid"] == min(132, (RES // 8) ** 2)
    assert cls.shape == ((RES // 8) ** 2,)
