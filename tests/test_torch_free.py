"""The pure-free split (``chunk_select.FreeWorkList``) and its carve (K5)
against the reference, and against the port's own unsplit integrate.

Scene: the furnished-room orbit at 128^3 / 160x120, so the volume
has 16 x 16 chunk columns and the split fires. Over the 3 m room a chunk
is the volume's whole depth, and the chunks that classify FREE there
hold no voxel in view (they lie at the frustum's edge): the carve rewrites
their planes tiles and changes no voxel. So the carve's parity also runs
on a 0.75 m cube of free space in front of the camera (5.9 mm voxels, as
at 512^3 over 3 m), where the members are carved. The reference runs as
its own tests run it (Pallas in ``interpret=True``), on each volume
layout: packed int32 and float32 (2, X, Y, Z). Bounds:

  * the free work list and the main list after the split: equal to the
    reference's (they are integer outputs of the same predicates);
  * split against unsplit in the port over 3 frames: bit-identical volume
    and planes, the reference's own bar for its split;
  * port against reference, frame 1 with the split in both from the
    reference's state after frame 0: the member chunks' volume data and
    planes tiles bit-identical. The carve has no bf16 split: both sides
    run the same float32 operations on the same inputs, so nothing
    rounds differently. Everywhere else the K4 bounds of
    ``tests/test_torch_integrate.py``: weights identical, the tsdf within
    one step (packed) on >= 99.9% of observed voxels or 1e-5 (float32),
    field 11 identical.
"""

import functools

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
    FreeWorkList,
    build_worklist,
    decode_free_worklist,
    decode_worklist,
)
from housescan_tpu_torch.ops.tsdf_stream import (
    FIELD_SAT,
    N_QUARTERS,
    launch_free_kernel,
    planes_shape,
    stream_grid,
    tsdf_integrate_stream,
)

JINTR = JIntrinsics(width=160, height=120, fx=131.25, fy=131.25, cx=79.5, cy=59.5)
INTR = Intrinsics(*JINTR)
RES = 128
TRUNC = 0.06
NB = RES // 8


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _scene(n):
    half, boxes = furnished_room()
    poses = orbit_poses(n, radius=0.25, yaw_range=0.3, pitch=0.25)
    frames = render_depth_stream(JINTR, poses, half, boxes=boxes)
    return np.asarray(frames), np.asarray(poses)


def _flags(planes):
    sat = planes[:, :, :, FIELD_SAT, :N_QUARTERS].reshape(-1, N_QUARTERS) > 0.5
    neg = planes[:, :, :, FIELD_SAT, N_QUARTERS].reshape(-1) > 0.5
    return sat, neg


LAYOUTS = {"packed": (jnp.int32, torch.int32), "float32": (jnp.float32, torch.float32)}


def _chunks(data):
    """(NB, NB, 1, 8, 8, 128[, ...]) chunk view of either layout (the
    float32 one with its (tsdf, weight) pair last)."""
    if data.ndim == 4:
        data = np.moveaxis(data, 0, -1)
    tail = data.shape[3:]
    return data.reshape((NB, 8, NB, 8, 1, 128) + tail).transpose(
        (0, 2, 4, 1, 3, 5) + tuple(range(6, 6 + len(tail))))


def _weights(data):
    return data & 0xFFFF if data.ndim == 3 else data[1]


def _carried(size_m, origin, layout="packed"):
    """The reference's state after frame 0 (unsplit), both packages' work
    lists for frame 1, and each package's frame 1 with the split from
    that state, on a 128^3 volume of ``size_m`` at ``origin``."""
    torch.set_num_threads(1)
    frames, poses = _scene(2)
    j_dtype, t_dtype = LAYOUTS[layout]
    jv = j_tsdf_new(RES, size_m, TRUNC, origin=None if origin is None else jnp.asarray(origin),
                    dtype=j_dtype)
    jp = jnp.zeros(planes_shape(RES), jnp.float32)
    jv, jp = j_integrate(jv, jp, jnp.asarray(frames[0]), jnp.asarray(poses[0]), JINTR,
                         interpret=True, free_split=False)
    data0, planes0 = np.array(jv.data), np.array(jp)
    sat, neg = _flags(planes0)
    d1, p1 = frames[1], poses[1]
    j_wl, j_fwl = j_build_worklist(
        jnp.asarray(d1), jnp.asarray(p1), JINTR, RES, jv.voxel_size, jv.origin, jv.trunc,
        sat_quarters=jnp.asarray(sat), neg_flags=jnp.asarray(neg), free_split=True)
    j_plain = j_build_worklist(
        jnp.asarray(d1), jnp.asarray(p1), JINTR, RES, jv.voxel_size, jv.origin, jv.trunc,
        sat_quarters=jnp.asarray(sat))
    tv = tsdf_new(RES, size_m, TRUNC, dtype=t_dtype, device="cpu",
                  origin=None if origin is None else torch.tensor(origin))
    t_wl, t_fwl = build_worklist(
        torch.from_numpy(d1), torch.from_numpy(p1), INTR, RES, tv.voxel_size, tv.origin,
        tv.trunc, sat_quarters=torch.from_numpy(sat), neg_flags=torch.from_numpy(neg),
        free_split=True)
    jv1, jp1 = j_integrate(jax.tree_util.tree_map(jnp.copy, jv), jnp.copy(jp), jnp.asarray(d1),
                           jnp.asarray(p1), JINTR, interpret=True, free_split=True)
    cuda_lib.reset_counts()
    tv = tv._replace(data=torch.from_numpy(data0.copy()))
    tp = torch.from_numpy(planes0.copy())
    tsdf_integrate_stream(tv, tp, torch.from_numpy(d1), torch.from_numpy(p1), INTR)
    counts = (dict(cuda_lib.launch_counts), dict(cuda_lib.plain_counts))
    return dict(
        j_wl=j_wl, j_fwl=j_fwl, j_plain=j_plain, t_wl=t_wl, t_fwl=t_fwl,
        data0=data0, j_data=np.asarray(jv1.data), j_planes=np.asarray(jp1),
        t_data=tv.data.numpy(), t_planes=tp.numpy(), counts=counts,
    )


# the 3 m room volume, and a 0.75 m cube of free space in front of the camera
SCENES = {"carried": (3.0, None), "carved": (0.75, (-0.375, -0.375, 0.35))}


@functools.lru_cache(maxsize=None)
def _scene_run(scene, layout):
    """Each (scene, layout) run once per module."""
    return _carried(*SCENES[scene], layout)


@pytest.fixture(scope="module", params=list(LAYOUTS))
def carried(request):
    return _scene_run("carried", request.param)


def test_free_worklist_matches_reference(carried):
    """Bitmap, count and coordinates of the real entries, and the main
    list left after the split."""
    j_fwl, t_fwl = carried["j_fwl"], carried["t_fwl"]
    n = int(np.asarray(j_fwl.count)[0])
    assert int(t_fwl.count[0]) == n
    for name in ("bitmap", "bi", "bj", "bk"):
        np.testing.assert_array_equal(getattr(t_fwl, name).numpy()[:n],
                                      np.asarray(getattr(j_fwl, name))[:n])
    assert sorted(decode_worklist(carried["t_wl"])) == sorted(j_decode_worklist(carried["j_wl"]))


def test_free_worklist_padding_repeats_last_entry(carried):
    t_fwl = carried["t_fwl"]
    n = int(t_fwl.count[0])
    for name in ("bitmap", "bi", "bj", "bk"):
        a = getattr(t_fwl, name).numpy()
        assert (a[n:] == a[n - 1]).all()


def test_split_actually_fires(carried):
    """Twin of the reference's check that the parity is not vacuous: the
    free list is non-empty and its members left the main list."""
    entries, members = decode_free_worklist(carried["t_fwl"])
    assert len(members) >= len(entries) > 0
    main = set(decode_worklist(carried["t_wl"]))
    plain = {r[:3] for r in j_decode_worklist(carried["j_plain"])}
    assert set(members) <= plain
    assert not set(members) & {r[:3] for r in main}
    assert len(main) + len(members) == len(plain)


@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("scene", list(SCENES))
def test_free_carve_bit_identical_to_reference_on_members(scene, layout):
    run = _scene_run(scene, layout)
    _, members = decode_free_worklist(run["t_fwl"])
    assert members
    m = np.zeros((NB, NB, 1), bool)
    for ci, cj, ck in members:
        m[ci, cj, ck] = True
    jd, td = _chunks(run["j_data"]), _chunks(run["t_data"])
    np.testing.assert_array_equal(td[m], jd[m])
    np.testing.assert_array_equal(run["t_planes"][m], run["j_planes"][m])
    if scene == "carved":  # the carve updated voxels there
        changed = td[m] != _chunks(run["data0"])[m]
        if changed.ndim == 5:  # float32: (tsdf, weight) last
            changed = changed.any(axis=-1)
        assert changed.sum() > 10000


@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("scene", list(SCENES))
def test_split_frame_within_k4_bounds_elsewhere(scene, layout):
    run = _scene_run(scene, layout)
    jd, td = run["j_data"], run["t_data"]
    np.testing.assert_array_equal(_weights(td), _weights(jd))
    obs = _weights(jd) > 0
    if jd.ndim == 3:
        dq = np.abs((td >> 16).astype(np.int64) - (jd >> 16))[obs]
        assert (dq <= 1).mean() >= 0.999
    else:
        assert np.abs(td[0] - jd[0])[obs].max() <= 1e-5
    np.testing.assert_array_equal(run["t_planes"][:, :, :, FIELD_SAT],
                                  run["j_planes"][:, :, :, FIELD_SAT])


def test_cpu_split_runs_plain_versions_only(carried):
    launched, plain = carried["counts"]
    assert plain["tsdf_free"] == 1 and plain["tsdf_stream"] == 1
    assert launched["tsdf_free"] == 0 and launched["tsdf_stream"] == 0


@pytest.mark.parametrize("dtype", [torch.int32, torch.float32], ids=["packed", "float32"])
def test_split_bit_identical_to_unsplit(dtype):
    """The port's split and unsplit integrates over 3 frames: the same
    volume and planes bit for bit."""
    frames, poses = _scene(3)
    va = tsdf_new(RES, 3.0, TRUNC, dtype=dtype, device="cpu")
    vb = tsdf_new(RES, 3.0, TRUNC, dtype=dtype, device="cpu")
    pa, pb = torch.zeros(planes_shape(RES)), torch.zeros(planes_shape(RES))
    n_free = 0
    for d, p in zip(frames, poses):
        d, p = torch.from_numpy(d), torch.from_numpy(p)
        sat, neg = _flags(pa)
        _, fwl = build_worklist(d, p, INTR, RES, va.voxel_size, va.origin, va.trunc,
                                sat_quarters=sat, neg_flags=neg, free_split=True)
        n_free += len(decode_free_worklist(fwl)[1])
        tsdf_integrate_stream(va, pa, d, p, INTR, free_split=True)
        tsdf_integrate_stream(vb, pb, d, p, INTR, free_split=False)
    assert n_free > 0
    assert torch.equal(va.data, vb.data)
    assert torch.equal(pa, pb)


def test_free_kernel_wrapper_refuses_cpu_tensors(carried):
    """The CUDA wrapper launches on CUDA tensors or raises; it never falls
    back to the plain version."""
    vol = torch.zeros((RES,) * 3, dtype=torch.int32)
    with pytest.raises(ValueError):
        launch_free_kernel(vol, torch.zeros(planes_shape(RES)), carried["t_fwl"],
                           torch.zeros(32))


@pytest.mark.parametrize("n_sb,count,resident,n_sms", [
    (1024, 300, 4, 132),  # 512^3: the orbit's frame-20 list
    (1024, 300, 3, 114),
    (1024, 0, 4, 132),  # an empty list
    (16, 3, 4, 132),  # 128^3: fewer items than the card holds blocks
    (64, 64, 1, 2),  # every entry listed, many items a block
])
def test_free_grid_walks_every_member_once(n_sb, count, resident, n_sms):
    """K5's persistent grid: stream_grid(16 n_sb, resident, SMs) blocks,
    block b taking items b, b + grid, ... below 16 x the count, item i the
    member slot i % 16 of entry i // 16, a clear member bit skipped (the
    kernel's loop, walked here in Python): every member chunk of the
    listed entries exactly once, and nothing else."""
    rng = np.random.default_rng(n_sb + count)
    side = 16
    cells = rng.permutation(side * side * 4)[:n_sb]  # distinct superblocks
    bitmap = rng.integers(0, 1 << 16, n_sb).astype(np.int32)
    bitmap[::7] = 0  # entries without a member
    fwl = FreeWorkList(
        bitmap=torch.from_numpy(bitmap), count=torch.tensor([count], dtype=torch.int32),
        bi=torch.from_numpy((cells // (side * 4)).astype(np.int32)),
        bj=torch.from_numpy((cells // 4 % side).astype(np.int32)),
        bk=torch.from_numpy((cells % 4).astype(np.int32)))
    grid = stream_grid(16 * n_sb, resident, n_sms)
    assert grid == min(16 * n_sb, resident * n_sms)
    bi, bj, bk = (a.tolist() for a in (fwl.bi, fwl.bj, fwl.bk))
    walked = [(bi[i // 16] * 4 + i % 16 // 4, bj[i // 16] * 4 + i % 4, bk[i // 16])
              for b in range(grid) for i in range(b, 16 * count, grid)
              if (int(bitmap[i // 16]) >> (i % 16)) & 1]
    members = decode_free_worklist(fwl)[1]
    assert len(walked) == len(set(walked)) == len(members)
    assert sorted(walked) == sorted(members)
