"""Parity of the port's plane raycast (K6 + masking) with the reference.

The same persistent planes (two frames fused by the port at 128^3) and
the same pose go through the reference's ``raycast_tiles_maps`` /
``raycast_planes`` (Pallas in interpret mode) and the port's. Per-tile
candidate lists must agree (the port selects with stable sorts on the
reference's keys), raw and final valid masks agree on >= 99.5% of
pixels, and depth, vertices and normals agree to 1e-5 where both are
valid (same float32 ray-plane arithmetic).
"""

import pytest

pytest.importorskip("jax")

import jax.numpy as jnp
import numpy as np
import torch

from housescan_tpu.kinfu.camera import Intrinsics as JIntrinsics
from housescan_tpu.kinfu.synthetic import furnished_room, orbit_poses, render_depth_stream
from housescan_tpu.kinfu.tsdf import TsdfVolume as JTsdfVolume
from housescan_tpu.ops.raycast_pallas import raycast_planes as j_raycast_planes
from housescan_tpu.ops.raycast_tiles import build_tile_candidates as j_candidates
from housescan_tpu.ops.raycast_tiles import raycast_tiles_maps as j_raw
from housescan_tpu_torch.kinfu.camera import Intrinsics
from housescan_tpu_torch.kinfu.tsdf import tsdf_new
from housescan_tpu_torch.ops.raycast_planes import raycast_planes
from housescan_tpu_torch.ops.raycast_tiles import (
    _ray_params,
    build_tile_candidates,
    raycast_tiles_maps,
    raycast_tiles_plain,
)
from housescan_tpu_torch.ops.tsdf_stream import planes_shape, tsdf_integrate_stream

JINTR = JIntrinsics(width=160, height=120, fx=131.25, fy=131.25, cx=79.5, cy=59.5)
INTR = Intrinsics(*JINTR)
VGA = Intrinsics(640, 480, 525.0, 525.0, 319.5, 239.5)
RES = 128


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def scene():
    """Planes from two fused frames; the raycast pose is frame 1's."""
    torch.set_num_threads(1)
    half, boxes = furnished_room()
    poses = np.array(orbit_poses(2, radius=0.25, yaw_range=0.1, pitch=0.25))
    frames = np.array(render_depth_stream(JINTR, poses, half, boxes=boxes))
    vol = tsdf_new(RES, 3.0, 0.06, dtype=torch.int32, device="cpu")
    planes = torch.zeros(planes_shape(RES))
    for d, p in zip(frames, poses):
        vol, planes = tsdf_integrate_stream(vol, planes, torch.from_numpy(d), torch.from_numpy(p), INTR)
    jvol = JTsdfVolume(
        data=jnp.asarray(vol.data.numpy()), origin=jnp.asarray(vol.origin.numpy()),
        voxel_size=jnp.asarray(vol.voxel_size.numpy()), trunc=jnp.asarray(vol.trunc.numpy()),
    )
    return dict(vol=vol, planes=planes, jvol=jvol, pose=poses[1])


def _both_valid_close(got, want, valid_got, valid_want, rows):
    agree = (valid_got == valid_want).mean()
    assert agree >= 0.995, agree
    both = valid_got & valid_want
    assert both.sum() > 5000
    for r in rows:
        np.testing.assert_allclose(got[r][both], want[r][both], atol=1e-5)


def test_candidates_match_reference(scene):
    got = build_tile_candidates(scene["planes"], torch.from_numpy(scene["pose"]), INTR, scene["vol"]).numpy()
    want = np.asarray(j_candidates(jnp.asarray(scene["planes"].numpy()), jnp.asarray(scene["pose"]),
                                   JINTR, scene["jvol"]))
    assert got.shape == want.shape == (30, 384, 16)
    assert (got[..., 9] > 0.5).sum() > 100
    np.testing.assert_array_equal(got[..., 8], want[..., 8])  # block ids, slot by slot
    np.testing.assert_allclose(got, want, atol=1e-6)


def test_raw_tiles_match_reference(scene):
    """K6 alone: raw rows before masking."""
    got = raycast_tiles_maps(scene["planes"], torch.from_numpy(scene["pose"]), INTR, scene["vol"]).numpy()
    want = np.asarray(j_raw(jnp.asarray(scene["planes"].numpy()), jnp.asarray(scene["pose"]),
                            JINTR, scene["jvol"], interpret=True))
    assert got.shape == want.shape == (9, 120, 160)
    _both_valid_close(got, want, got[0] > 0, want[0] > 0, range(7))
    both = (got[0] > 0) & (want[0] > 0)
    assert (got[7][both] == want[7][both]).mean() >= 0.995
    occ = (got[8] < 1e9) & (want[8] < 1e9)
    np.testing.assert_allclose(got[8][occ], want[8][occ], atol=1e-5)


def test_model_maps_match_reference(scene):
    got = raycast_planes(scene["planes"], torch.from_numpy(scene["pose"]), INTR, scene["vol"]).numpy()
    want = np.asarray(j_raycast_planes(jnp.asarray(scene["planes"].numpy()), jnp.asarray(scene["pose"]),
                                       JINTR, scene["jvol"], interpret=True))
    assert got.shape == want.shape == (8, 120, 160)
    _both_valid_close(got, want, got[7] > 0.5, want[7] > 0.5, range(7))


def test_rejects_unbanded_height(scene):
    intr = Intrinsics(160, 124, 131.25, 131.25, 79.5, 61.5)
    with pytest.raises(ValueError):
        raycast_tiles_maps(scene["planes"], torch.eye(4), intr, scene["vol"])


@pytest.mark.parametrize("cam", ["160x120", "640x480"])
def test_usable_candidates_lead_each_tile(scene, cam):
    """K6 loops over each tile's rows up to its last usable one: in every
    tile the usable rows (ok = 1) come first and every row after them is
    zero, under both budgets (384 slots below 128 tiles, 96 above)."""
    intr = INTR if cam == "160x120" else VGA
    cand = build_tile_candidates(scene["planes"], torch.from_numpy(scene["pose"]), intr, scene["vol"])
    assert cand.shape[1] == (384 if cam == "160x120" else 96)
    ok = cand[:, :, 9] > 0.5
    counts = ok.sum(dim=1)
    assert torch.equal(ok, torch.arange(cand.shape[1])[None, :] < counts[:, None])
    assert not bool(cand[~ok].any())
    assert int(counts.sum()) > 100 and int((counts > 0).sum()) > cand.shape[0] // 4


def test_plain_raycast_independent_of_candidate_order(scene):
    """The nearest hit (ties to the larger block id) and the nearest
    occluder of a pixel do not depend on the order of its tile's
    candidates, whose block ids are unique: K6's plain version gives the
    same 9 rows bit for bit with each tile's usable rows reversed."""
    pose = torch.from_numpy(scene["pose"])
    cand = build_tile_candidates(scene["planes"], pose, INTR, scene["vol"])
    counts = (cand[:, :, 9] > 0.5).sum(dim=1)
    for g, n in enumerate(counts.tolist()):
        ids = cand[g, :n, 8]
        assert len(set(ids.tolist())) == n
    shuffled = cand.clone()
    for g, n in enumerate(counts.tolist()):
        shuffled[g, :n] = cand[g, :n].flip(0)
    assert not torch.equal(shuffled, cand)
    params = _ray_params(pose, INTR, 0.3, 2)
    want = raycast_tiles_plain(cand, params, 120, 256)
    got = raycast_tiles_plain(shuffled, params, 120, 256)
    assert int((want[0] > 0).sum()) > 5000
    assert torch.equal(got, want)
