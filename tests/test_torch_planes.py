"""Parity of the port's whole-volume plane extraction (K7) and of
``raycast_pallas`` with the reference.

Volume: four frames of the furnished-room orbit (160x120) fused by the
reference's XLA integrate into a 128^3 volume over 3 m, once in each
layout (float32 and packed); the reference's ``test_raycast_depth_quality``
fuses the same one. Both packages extract its planes: the reference's
``extract_subblock_planes(interpret=True)``, the port's plain version of
K7. Bounds:

  * the count field identical (an integer count of the same crossing
    tests on the same values);
  * valid flags on >= 99.9% of sub-blocks;
  * every field of every chunk, valid or not: fields 0-3 (normal, offset;
    zero where invalid) and 12 (lambda_min) within 1e-4, the rest within
    1e-5, field 11 zero: the bounds of the K4 plane test
    (``tests/test_torch_integrate.py``: the reference sums the moments in
    float32, the port in float64);
  * the count against the crossing truth of the reference's
    ``test_plane_extraction_matches_band_counts``, computed from the
    volume in numpy;
  * the same bounds on built volumes of (64, 64, 256) in both layouts: an
    empty one, and a sparse one whose chunks are unobserved but for one
    with a single observed sub-block (on two rows in three) and one whose
    observed sub-blocks carry a surface across a sub-block boundary in z:
    the cases K7's weight-first kernel skips or fetches in part;
  * ``raycast_pallas`` at the first pose against the reference's: valid
    masks on >= 99% of pixels (the masks of K6's tests), depth within
    1e-4 m on >= 99.9% of the jointly valid pixels (the planes differ by
    the bounds above: a 1e-4 normal tilt moves a hit 2 m away by 2e-4 m
    at most, far less on the planes a ray meets head-on); and the
    reference's own quality gates on the port's maps.
"""

import pytest

pytest.importorskip("jax")

import jax.numpy as jnp
import numpy as np
import torch

from housescan_tpu.kinfu.camera import Intrinsics as JIntrinsics
from housescan_tpu.kinfu.synthetic import furnished_room, orbit_poses, render_depth_stream
from housescan_tpu.kinfu.tsdf import tsdf_integrate as j_integrate
from housescan_tpu.kinfu.tsdf import pack_tw as j_pack_tw
from housescan_tpu.kinfu.tsdf import tsdf_new as j_tsdf_new
from housescan_tpu.ops.planes_pallas import extract_subblock_planes as j_extract
from housescan_tpu.ops.raycast_pallas import raycast_pallas as j_raycast_pallas
from housescan_tpu_torch.kinfu import maps as mp
from housescan_tpu_torch.kinfu.camera import Intrinsics
from housescan_tpu_torch.kinfu.tsdf import TsdfVolume
from housescan_tpu_torch.ops import cuda_lib
from housescan_tpu_torch.ops.planes_cuda import (
    _extract_params,
    extract_subblock_planes,
    launch_extract_kernel,
)
from housescan_tpu_torch.ops.raycast_planes import raycast_pallas
from housescan_tpu_torch.ops.tsdf_stream import FIELD_SAT

JINTR = JIntrinsics(width=160, height=120, fx=131.25, fy=131.25, cx=79.5, cy=59.5)
INTR = Intrinsics(*JINTR)
RES = 128
NB = RES // 8


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def scene():
    half, boxes = furnished_room()
    poses = orbit_poses(4, radius=0.25, yaw_range=0.1, pitch=0.25)
    frames = render_depth_stream(JINTR, poses, half, boxes=boxes)
    return np.asarray(frames), np.asarray(poses)


def _fuse(scene, j_dtype):
    frames, poses = scene
    jv = j_tsdf_new(RES, 3.0, 0.06, dtype=j_dtype)
    for k in range(len(frames)):
        jv = j_integrate(jv, jnp.asarray(frames[k]), jnp.asarray(poses[k]), JINTR)
    return jv


def _port_volume(jv):
    return TsdfVolume(*(torch.from_numpy(np.array(getattr(jv, k)))
                        for k in ("data", "origin", "voxel_size", "trunc")))


@pytest.fixture(scope="module", params=["float32", "packed"])
def extracted(scene, request):
    """Both packages' planes of the fused volume of one layout."""
    torch.set_num_threads(1)
    jv = _fuse(scene, jnp.float32 if request.param == "float32" else jnp.int32)
    want = np.asarray(j_extract(jv, interpret=True))
    tv = _port_volume(jv)
    got = extract_subblock_planes(tv).numpy()
    return dict(want=want, got=got, tsdf=tv.tsdf.numpy(), weight=tv.weight.numpy(), vol=tv)


def _built_grids(kind, dims, seed=0):
    """(tsdf, weight) float32 numpy grids: "empty" (nothing observed) or
    "sparse" (sub-block 5 of chunk (1, 2, last) alone observed on two rows
    in three, a tilted plane crossing it; sub-blocks 6-9 of chunk (3, 0,
    0) observed, a surface at z ~ 63.5 crossing from sub-block 7 into 8;
    every other chunk unobserved)."""
    rng = np.random.default_rng(seed)
    t = np.ones(dims, np.float32)
    w = np.zeros(dims, np.float32)
    if kind == "sparse":
        x, y, z = np.meshgrid(*(np.arange(8, dtype=np.float32),) * 3, indexing="ij")
        z0 = (dims[2] // 128 - 1) * 128 + 5 * 8
        t[8:16, 16:24, z0:z0 + 8] = np.clip((z - 3.5 + 0.4 * x - 0.2 * y) / 3.0, -1.0, 1.0)
        w[8:16, 16:24, z0:z0 + 8] = np.where((x + y) % 3 == 0, 0.0, rng.integers(1, 9, (8, 8, 8)))
        x, y, z = np.meshgrid(np.arange(8, dtype=np.float32), np.arange(8, dtype=np.float32),
                              np.arange(48, 80, dtype=np.float32), indexing="ij")
        t[24:32, 0:8, 48:80] = np.clip((z - 63.5 - 0.3 * x + 0.25 * y) / 4.0, -1.0, 1.0)
        w[24:32, 0:8, 48:80] = rng.integers(1, 20, x.shape)
    return t, w


@pytest.fixture(scope="module", params=[("empty", "float32"), ("empty", "packed"),
                                        ("sparse", "float32"), ("sparse", "packed")],
                ids=lambda p: "-".join(p))
def built(request):
    """Both packages' planes of a built (64, 64, 256) volume."""
    torch.set_num_threads(1)
    kind, layout = request.param
    t, w = _built_grids(kind, (64, 64, 256))
    packed = layout == "packed"
    jv = j_tsdf_new(64, 3.0, 0.06, dtype=jnp.int32 if packed else jnp.float32)
    t, w = jnp.asarray(t), jnp.asarray(w)
    jv = jv._replace(data=j_pack_tw(t, w) if packed else jnp.stack([t, w]))
    want = np.asarray(j_extract(jv, interpret=True))
    got = extract_subblock_planes(_port_volume(jv)).numpy()
    return dict(kind=kind, want=want, got=got)


def test_built_volume_matches_reference(built):
    """Every field of every chunk within the bounds above, counts and
    valid flags identical: the empty volume has no crossing anywhere, the
    sparse one crossings in exactly its two observed chunks."""
    got, want = built["got"], built["want"]
    assert got.shape == want.shape == (8, 8, 2, 16, 16)
    np.testing.assert_array_equal(got[:, :, :, 5], want[:, :, :, 5])
    np.testing.assert_array_equal(got[:, :, :, 4] > 0.5, want[:, :, :, 4] > 0.5)
    for f in range(16):
        atol = 1e-4 if f in (0, 1, 2, 3, 12) else 1e-5
        np.testing.assert_allclose(got[:, :, :, f], want[:, :, :, f], atol=atol)
    crossed = np.argwhere((got[:, :, :, 5] > 0).any(-1))
    if built["kind"] == "empty":
        assert len(crossed) == 0
    else:
        assert sorted(map(tuple, crossed)) == [(1, 2, 1), (3, 0, 0)]
        assert int((got[1, 2, 1, 5] > 0).sum()) == 1 and got[1, 2, 1, 4, 5] > 0.5
        assert got[3, 0, 0, 4, 7] > 0.5


@pytest.fixture(scope="module")
def rendered(scene):
    """Both packages' ``raycast_pallas`` at the first pose, on the float32
    volume."""
    torch.set_num_threads(1)
    frames, poses = scene
    jv = _fuse(scene, jnp.float32)
    want = np.asarray(j_raycast_pallas(jv, jnp.asarray(poses[0]), JINTR, interpret=True))
    cuda_lib.reset_counts()
    got = raycast_pallas(_port_volume(jv), torch.from_numpy(poses[0]), INTR).numpy()
    counts = (dict(cuda_lib.launch_counts), dict(cuda_lib.plain_counts))
    return dict(want=want, got=got, truth=frames[0], counts=counts)


def test_count_field_identical(extracted):
    np.testing.assert_array_equal(extracted["got"][:, :, :, 5], extracted["want"][:, :, :, 5])


def test_valid_flags_agree(extracted):
    jv, tv = extracted["want"][:, :, :, 4] > 0.5, extracted["got"][:, :, :, 4] > 0.5
    assert jv.sum() > 30
    assert (jv == tv).mean() >= 0.999


def test_every_field_of_every_chunk(extracted):
    """K7 writes every field of every chunk, also where no plane is valid."""
    got, want = extracted["got"], extracted["want"]
    for f in range(16):
        atol = 1e-4 if f in (0, 1, 2, 3, 12) else 1e-5
        np.testing.assert_allclose(got[:, :, :, f], want[:, :, :, f], atol=atol)
    assert not got[:, :, :, FIELD_SAT].any()
    assert (got[:, :, :, 6] > 0).sum() == got[:, :, :, 6].size - 1  # ids: all but sub-block 0


def test_count_matches_crossing_truth(extracted):
    """Port of the reference's ``test_plane_extraction_matches_band_counts``:
    a crossing between a voxel and its +axis neighbour counts in the base
    voxel's sub-block; x and y crossings across an 8-voxel block boundary
    and z crossings across a 128-voxel chunk boundary are skipped; where
    valid, the normals are unit."""
    t, w = extracted["tsdf"], extracted["weight"]
    obs = w > 0
    neg = t < 0

    def fam(axis, keep_base):
        sl = [slice(None)] * 3
        sl[axis] = slice(0, -1)
        sln = [slice(None)] * 3
        sln[axis] = slice(1, None)
        c = obs[tuple(sl)] & obs[tuple(sln)] & (neg[tuple(sl)] != neg[tuple(sln)])
        full = np.zeros_like(obs)
        full[tuple(sl)] = c
        return full & keep_base

    ix = np.arange(RES)
    keep_x = (ix % 8 != 7)[:, None, None]
    keep_y = (ix % 8 != 7)[None, :, None]
    keep_z = (ix % 128 != 127)[None, None, :]
    cross = (fam(0, keep_x).astype(np.int64) + fam(1, keep_y) + fam(2, keep_z))
    truth = cross.reshape(NB, 8, NB, 8, RES // 8, 8).sum(axis=(1, 3, 5))
    got = extracted["got"]
    np.testing.assert_array_equal(got[:, :, 0, 5, :], truth)
    valid = got[:, :, 0, 4, :] > 0
    norms = np.linalg.norm(got[:, :, 0, 0:3, :], axis=2)
    assert valid.sum() > 30
    assert np.allclose(norms[valid], 1.0, atol=1e-4)


def test_raycast_pallas_matches_reference(rendered):
    got, want = rendered["got"], rendered["want"]
    assert got.shape == want.shape == (8, INTR.height, INTR.width)
    gv, wv = got[mp.MD_VALID] > 0.5, want[mp.MD_VALID] > 0.5
    assert wv.mean() > 0.5
    assert (gv == wv).mean() >= 0.99
    both = gv & wv
    diff = np.abs(got[mp.MD_DEPTH] - want[mp.MD_DEPTH])[both]
    assert (diff <= 1e-4).mean() >= 0.999


def test_raycast_pallas_depth_quality(rendered):
    """The reference's ``test_raycast_depth_quality`` gates, on the port's
    maps: coverage > 0.55, median |depth - true depth| < 0.5 mm on the
    jointly valid pixels, and fewer than 4% of them off by > 10 mm."""
    got, truth = rendered["got"], rendered["truth"]
    valid = got[mp.MD_VALID] > 0.5
    assert valid.mean() > 0.55
    m = valid & (truth > 0)
    err = np.abs(got[mp.MD_DEPTH][m] - truth[m])
    assert np.median(err) < 0.0005
    assert (err > 0.01).mean() < 0.04


def test_raycast_pallas_runs_plain_versions_on_cpu(rendered):
    launched, plain = rendered["counts"]
    assert plain["planes_extract"] == 1 and plain["raycast_tiles"] == 1
    assert not any(launched.values())


def test_extract_kernel_wrapper_refuses_cpu_tensors(extracted):
    vol = extracted["vol"]
    with pytest.raises(ValueError):
        launch_extract_kernel(vol.data, _extract_params(vol, 6.0, NB))
