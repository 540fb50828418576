"""Parity of the port's work-list TSDF integrate (K4) with the reference.

Two frames of the furnished-room orbit go through the reference's
``tsdf_integrate_stream`` (Pallas in interpret mode, ``free_split=False``,
the configuration the port implements) and through the port's plain
path, from the same fresh 128^3 volume, in each layout: packed int32 and
the float32 (2, X, Y, Z) array (the reference's tests run its stream
kernel on both). Tolerances:

  * weights: identical (integer counts; the port reproduces the
    reference's update predicates operation for operation);
  * tsdf: packed, within one quantization step (1/32767) on >= 99.9% of
    observed voxels; float32, within 1e-5 there. The port computes the
    bilinear depth in plain float32 where the reference splits it into
    bf16 hi/lo parts, a last-bit difference of the depth (~2.4e-7 m at
    2 m, 4e-6 over the 0.06 m truncation) that can also move a packed
    rounding to the next step;
  * planes of listed chunks: valid flags agree on >= 99.9% of
    sub-blocks, fields within 1e-5 where both are valid (the reference's
    own plane-refresh bound), field 11 (saturation/negative flags)
    identical. Fields 0-3 (normal, offset) and 12 (lambda_min) get 1e-4:
    the reference sums the crossing moments in float32 and forms the
    covariance as E[p^2] - E[p]^2 with |p| <= 8 voxels, so each entry
    carries rounding of ulp(64) = 7.6e-6 voxel^2; lambda_min inherits it
    directly and the normal's off-axis components divided by the
    eigen-gap, which the validity gate keeps >= 0.1 (<= 7.6e-5; the port
    sums in float64, measured max 1.7e-5);
  * unlisted chunks: volume data and planes bit-identical;
  * K7 as the oracle (twin of the reference's
    ``test_planes_match_standalone_extraction``): a fresh extraction over
    the integrated volume equals K4's planes on every listed chunk, valid
    flags identical and every field but 11 (K4's flags) within 1e-5
    where valid.
"""

import pytest

pytest.importorskip("jax")

import jax
import jax.numpy as jnp
import numpy as np
import torch

from housescan_tpu.kinfu.camera import Intrinsics as JIntrinsics
from housescan_tpu.kinfu.synthetic import furnished_room, orbit_poses, render_depth_stream
from housescan_tpu.kinfu.tsdf import tsdf_new as j_tsdf_new
from housescan_tpu.ops.chunk_select import build_worklist as j_build_worklist
from housescan_tpu.ops.chunk_select import decode_worklist as j_decode_worklist
from housescan_tpu.ops.tsdf_stream import tsdf_integrate_stream as j_integrate
from housescan_tpu_torch.kinfu.camera import Intrinsics
from housescan_tpu_torch.kinfu.tsdf import tsdf_new
from housescan_tpu_torch.ops import cuda_lib
from housescan_tpu_torch.ops.chunk_select import (
    build_worklist,
    decode_worklist,
    launch_chunk_select,
)
from housescan_tpu_torch.ops.planes_cuda import extract_subblock_planes
from housescan_tpu_torch.ops.tsdf_stream import (
    FIELD_SAT,
    _stream_params,
    planes_shape,
    stream_grid,
    tsdf_integrate_stream,
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
    poses = orbit_poses(2, radius=0.25, yaw_range=0.3, pitch=0.25)
    frames = render_depth_stream(JINTR, poses, half, boxes=boxes)
    return np.asarray(frames), np.asarray(poses)


LAYOUTS = {"packed": (jnp.int32, torch.int32), "float32": (jnp.float32, torch.float32)}


@pytest.fixture(scope="module", params=list(LAYOUTS))
def runs(request):
    """Both packages over two frames in one layout, with each frame's work
    list."""
    torch.set_num_threads(1)
    frames, poses = _scene()
    j_dtype, t_dtype = LAYOUTS[request.param]
    jv = j_tsdf_new(RES, 3.0, TRUNC, dtype=j_dtype)
    jp = jnp.zeros(planes_shape(RES), jnp.float32)
    tv = tsdf_new(RES, 3.0, TRUNC, dtype=t_dtype, device="cpu")
    tp = torch.zeros(planes_shape(RES))
    j_lists, t_lists = [], []
    for i in range(2):
        d, p = frames[i], poses[i]
        sat = np.asarray(jp)[:, :, :, FIELD_SAT, :4].reshape(-1, 4) > 0.5
        j_lists.append(sorted(j_decode_worklist(j_build_worklist(
            jnp.asarray(d), jnp.asarray(p), JINTR, RES, jv.voxel_size, jv.origin,
            jv.trunc, sat_quarters=jnp.asarray(sat)))))
        jv, jp = j_integrate(
            jax.tree_util.tree_map(jnp.copy, jv), jnp.copy(jp), jnp.asarray(d),
            jnp.asarray(p), JINTR, interpret=True, free_split=False,
        )
        tsat = tp[:, :, :, FIELD_SAT, :4].reshape(-1, 4) > 0.5
        t_lists.append(sorted(decode_worklist(build_worklist(
            torch.from_numpy(d), torch.from_numpy(p), INTR, RES, tv.voxel_size,
            tv.origin, tv.trunc, sat_quarters=tsat))))
        tv, tp = tsdf_integrate_stream(tv, tp, torch.from_numpy(d), torch.from_numpy(p), INTR)
    return dict(
        j_data=np.asarray(jv.data), j_planes=np.asarray(jp),
        t_data=tv.data.numpy(), t_planes=tp.numpy(),
        j_lists=j_lists, t_lists=t_lists,
    )


def _weights(data):
    return data & 0xFFFF if data.ndim == 3 else data[1]


def _tsdf_q(data):
    """The tsdf in quantization steps (packed) or as stored (float32)."""
    return data >> 16 if data.ndim == 3 else data[0]


def test_worklist_matches_reference(runs):
    """Same listed chunks with the same (class, level, window) per frame."""
    for jl, tl in zip(runs["j_lists"], runs["t_lists"]):
        assert len(tl) > 20
        assert jl == tl


def test_weights_identical(runs):
    np.testing.assert_array_equal(_weights(runs["t_data"]), _weights(runs["j_data"]))
    assert _weights(runs["t_data"]).max() == 2


def test_packed_tsdf_within_one_step(runs):
    """The stored tsdf: one quantization step (packed) or 1e-5 (float32)."""
    obs = _weights(runs["j_data"]) > 0
    assert obs.sum() > 10000
    if runs["j_data"].ndim == 3:
        dq = np.abs(_tsdf_q(runs["t_data"]).astype(np.int64) - _tsdf_q(runs["j_data"]))[obs]
        assert (dq <= 1).mean() >= 0.999, np.bincount(dq)[:4]
    else:
        assert np.abs(_tsdf_q(runs["t_data"]) - _tsdf_q(runs["j_data"]))[obs].max() <= 1e-5


def test_planes_agree(runs):
    jp, tp = runs["j_planes"], runs["t_planes"]
    jv, tv = jp[:, :, :, 4, :] > 0.5, tp[:, :, :, 4, :] > 0.5
    assert jv.sum() > 30
    assert (jv == tv).mean() >= 0.999
    both = jv & tv
    for f in range(16):
        if f == FIELD_SAT:
            continue
        atol = 1e-4 if f in (0, 1, 2, 3, 12) else 1e-5
        np.testing.assert_allclose(tp[:, :, :, f, :][both], jp[:, :, :, f, :][both], atol=atol)


def test_saturation_field_identical(runs):
    np.testing.assert_array_equal(
        runs["t_planes"][:, :, :, FIELD_SAT, :], runs["j_planes"][:, :, :, FIELD_SAT, :]
    )


def test_unlisted_chunks_bit_identical():
    """Chunks off the work list keep volume data and planes bit for bit
    (256^3: chunks there are short enough in z that some are skipped)."""
    res = 256
    frames, poses = _scene()
    rng = np.random.default_rng(1)
    data0 = torch.from_numpy(rng.integers(-2**31, 2**31 - 1, (res,) * 3, dtype=np.int64).astype(np.int32))
    planes0 = torch.from_numpy(rng.normal(size=planes_shape(res)).astype(np.float32))
    vol = tsdf_new(res, 3.0, TRUNC, dtype=torch.int32, device="cpu")._replace(data=data0.clone())
    planes = planes0.clone()
    d, p = torch.from_numpy(frames[0]), torch.from_numpy(poses[0])
    sat = planes[:, :, :, FIELD_SAT, :4].reshape(-1, 4) > 0.5
    wl = build_worklist(d, p, INTR, res, vol.voxel_size, vol.origin, vol.trunc, sat_quarters=sat)
    listed = np.zeros(planes_shape(res)[:3], bool)
    for ci, cj, ck, *_ in decode_worklist(wl):
        listed[ci, cj, ck] = True
    assert 0 < listed.sum() < listed.size
    tsdf_integrate_stream(vol, planes, d, p, INTR)
    nb, nz = res // 8, res // 128

    def chunks(a):
        return a.numpy().reshape(nb, 8, nb, 8, nz, 128).transpose(0, 2, 4, 1, 3, 5)

    np.testing.assert_array_equal(chunks(vol.data)[~listed], chunks(data0)[~listed])
    np.testing.assert_array_equal(planes.numpy()[~listed], planes0.numpy()[~listed])
    assert (chunks(vol.data)[listed] != chunks(data0)[listed]).any()


def test_rejects_untileable_volume():
    vol = tsdf_new(96, 3.0, TRUNC, dtype=torch.int32, device="cpu")
    with pytest.raises(ValueError):
        tsdf_integrate_stream(vol, torch.zeros(12, 12, 0, 16, 16), torch.zeros(120, 160),
                              torch.eye(4), INTR)


@pytest.mark.parametrize("res", [256, 512])
def test_worklist_matches_reference_at_resolution(res):
    """At 256^3 and 512^3 the reference pairs z-adjacent chunks into
    superchunk entries; the port's single-chunk list must hold exactly the
    reference's non-NOOP chunks with the same descriptors."""
    frames, poses = _scene()
    d, p = frames[1], poses[1]
    jv = j_tsdf_new(res, 3.0, TRUNC, dtype=jnp.int32)
    want = sorted(j_decode_worklist(j_build_worklist(
        jnp.asarray(d), jnp.asarray(p), JINTR, res, jv.voxel_size, jv.origin, jv.trunc)))
    tv = tsdf_new(res, 3.0, TRUNC, dtype=torch.int32, device="cpu")
    got = sorted(decode_worklist(build_worklist(
        torch.from_numpy(d), torch.from_numpy(p), INTR, res, tv.voxel_size, tv.origin, tv.trunc)))
    assert len(got) > 100
    assert got == want


@pytest.mark.parametrize("dtype", [torch.int32, torch.float32], ids=["packed", "float32"])
def test_planes_match_standalone_extraction(dtype):
    """K7 as the oracle: the persistent planes of every listed chunk equal
    a fresh extraction over the integrated volume where valid (twin of the
    reference's test of that name)."""
    frames, poses = _scene()
    d, p = torch.from_numpy(frames[0]), torch.from_numpy(poses[0])
    vol = tsdf_new(RES, 3.0, TRUNC, dtype=dtype, device="cpu")
    planes = torch.zeros(planes_shape(RES))
    wl = build_worklist(d, p, INTR, RES, vol.voxel_size, vol.origin, vol.trunc)
    tsdf_integrate_stream(vol, planes, d, p, INTR)
    want = extract_subblock_planes(vol).numpy()
    got = planes.numpy()
    fields = [f for f in range(16) if f != FIELD_SAT]
    n_valid = 0
    for ci, cj, ck, *_ in decode_worklist(wl):
        g, w_ = got[ci, cj, ck], want[ci, cj, ck]
        np.testing.assert_array_equal(g[4] > 0.5, w_[4] > 0.5)
        m = w_[4] > 0.5
        np.testing.assert_allclose(g[fields][:, m], w_[fields][:, m], atol=1e-5)
        n_valid += int(m.sum())
    assert n_valid > 30


@pytest.mark.parametrize("n_desc,resident,n_sms,count", [
    (16384, 1, 132, 1124),  # 512^3 chunks, the orbit's main list
    (16384, 2, 114, 1124),
    (16384, 1, 132, 0),
    (16384, 1, 132, 1),
    (256, 1, 132, 256),  # 128^3: fewer rows than the card holds blocks
    (2048, 3, 132, 397),
])
def test_stream_grid_walks_every_listed_row_once(n_desc, resident, n_sms, count):
    """K4's persistent grid: min(n_desc, resident x SMs) blocks, block b
    taking rows b, b + grid, ... below the count (the kernel's stride
    loop, walked here in Python): every listed row exactly once."""
    grid = stream_grid(n_desc, resident, n_sms)
    assert grid == min(n_desc, resident * n_sms)
    rows = [c for b in range(grid) for c in range(b, count, grid)]
    assert sorted(rows) == list(range(count))


@pytest.mark.parametrize("free_split", [True, False], ids=["split", "unsplit"])
def test_cpu_integrate_runs_the_plain_prepass_once_a_call(free_split):
    """On CPU tensors every ``tsdf_integrate_stream`` call runs the plain
    ``build_worklist`` once (``plain_counts["chunk_select"]``, as K4's and
    K5's plain versions count) and launches no kernel."""
    frames, poses = _scene()
    vol = tsdf_new(RES, 3.0, TRUNC, dtype=torch.int32, device="cpu")
    planes = torch.zeros(planes_shape(RES))
    cuda_lib.reset_counts()
    for k in range(2):
        tsdf_integrate_stream(vol, planes, torch.from_numpy(frames[k]), torch.from_numpy(poses[k]),
                              INTR, free_split=free_split)
        assert cuda_lib.plain_counts["chunk_select"] == k + 1
    assert not any(cuda_lib.launch_counts.values())


@pytest.mark.parametrize("bad", ["planes", "depth_small", "depth_3d", "params", "volume"])
def test_chunk_select_kernel_wrapper_raises_on_bad_shapes_before_launching(bad):
    """K9's wrapper checks every shape before it asks for a device: a planes
    tensor of another volume, a depth image under one 8 x 8 cell or not 2-D,
    a params vector short of ``_stream_params``' slots and a volume with no
    whole chunk raise ``ValueError`` naming the prepass, and nothing is
    launched."""
    frames, poses = _scene()
    vol = tsdf_new(RES, 3.0, TRUNC, dtype=torch.int32, device="cpu")
    depth, pose = torch.from_numpy(frames[0]), torch.from_numpy(poses[0])
    planes = torch.zeros(planes_shape(RES))
    params = _stream_params(vol, pose, INTR, 128.0, RES // 8, RES // 128)
    dims = vol.dims
    if bad == "planes":
        planes = torch.zeros(planes_shape(2 * RES))
    elif bad == "depth_small":
        depth = depth[:4]
    elif bad == "depth_3d":
        depth = depth[None]
    elif bad == "params":
        params = params[:20]
    else:
        dims = (4, RES, RES)
    cuda_lib.reset_counts()
    with pytest.raises(ValueError, match="chunk_select"):
        launch_chunk_select(depth, planes, params, INTR, dims, True)
    assert not any(cuda_lib.launch_counts.values())
