"""The bfloat16 volume layout of the port against the reference.

The (2, X, Y, Z) bfloat16 volume (``TsdfConfig.dtype="bfloat16"``)
through the port's plain versions of K4 and K5 and its XLA path, held
against the JAX package (Pallas in interpret mode) on the furnished-room
orbit at 128^3, 160x120. Tolerances:

  * weights: identical (integer counts below 256 are exact in bfloat16);
  * the work-list integrate: the tsdf within one bfloat16 ulp of the
    reference's (both compute in float32 and round once to nearest even,
    but the port's bilinear depth differs from the reference's bf16
    hi/lo split in its last bit, which can move a rounding); planes to
    ``test_torch_integrate.py``'s bounds;
  * the XLA path: one bfloat16 ulp too (the running mean is bfloat16
    arithmetic in both; XLA on the CPU may keep float32 between fused
    bfloat16 operations where torch rounds after each);
  * the step, teacher-forced from the reference's state: poses within
    1e-4 (the pipeline parity's bound), the same tracking decisions.
"""

import pytest

pytest.importorskip("jax")

import jax
import jax.numpy as jnp
import numpy as np
import torch

from housescan_tpu.kinfu.camera import Intrinsics as JIntrinsics
from housescan_tpu.kinfu.pipeline import kinfu_init as j_init
from housescan_tpu.kinfu.pipeline import kinfu_step as j_step
from housescan_tpu.kinfu.synthetic import furnished_room, orbit_poses, render_depth_stream
from housescan_tpu.kinfu.tsdf import tsdf_new as j_tsdf_new
from housescan_tpu.ops.tsdf_stream import tsdf_integrate_stream as j_integrate
from housescan_tpu_torch.config import TsdfConfig
from housescan_tpu_torch.kinfu.camera import Intrinsics
from housescan_tpu_torch.kinfu.pipeline import kinfu_step, state_from_numpy
from housescan_tpu_torch.kinfu.tsdf import from_config, tsdf_new
from housescan_tpu_torch.ops.tsdf_cuda import tsdf_integrate_with_planes
from housescan_tpu_torch.ops.tsdf_stream import FIELD_SAT, planes_shape, tsdf_integrate_stream

JINTR = JIntrinsics(width=160, height=120, fx=131.25, fy=131.25, cx=79.5, cy=59.5)
INTR = Intrinsics(*JINTR)
RES = 128
TRUNC = 0.06


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def scene():
    half, boxes = furnished_room()
    poses = orbit_poses(3, radius=0.25, yaw_range=0.3, pitch=0.25)
    frames = render_depth_stream(JINTR, poses, half, boxes=boxes)
    return np.asarray(frames), np.asarray(poses)


def _f32(data) -> np.ndarray:
    """A volume's data (torch tensor or reference array) as float32 numpy."""
    if isinstance(data, torch.Tensor):
        return data.float().numpy()
    return np.asarray(jnp.asarray(data, jnp.float32))


def _within_one_ulp(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """|a - b| <= one bfloat16 ulp at the larger magnitude (8 significant
    bits: ulp(x) = 2^(floor(log2 |x|) - 7))."""
    m = np.maximum(np.abs(a), np.abs(b))
    ulp = np.exp2(np.floor(np.log2(np.maximum(m, 2.0 ** -126))) - 7)
    return np.abs(a - b) <= ulp


def _port_stream(frames, poses, dtype, n):
    vol = tsdf_new(RES, 3.0, TRUNC, dtype=dtype, device="cpu")
    planes = torch.zeros(planes_shape(RES))
    for d, p in zip(frames[:n], poses[:n]):
        vol, planes = tsdf_integrate_stream(vol, planes, torch.from_numpy(d), torch.from_numpy(p),
                                            INTR)
    return vol, planes


def test_bf16_parity_with_f32(scene):
    """Twin of the reference's ``test_bf16_parity_with_f32``: one fused
    frame into a bfloat16 and a float32 volume; weights equal, the tsdf
    within 5e-4 near the crossing (|t| < 0.1) and 4.5e-3 (a bfloat16 ulp
    at |t| <= 1) wherever observed."""
    frames, poses = scene
    v32, _ = _port_stream(frames, poses, torch.float32, 1)
    v16, _ = _port_stream(frames, poses, torch.bfloat16, 1)
    assert v16.data.dtype == torch.bfloat16
    w32, w16 = _f32(v32.data[1]), _f32(v16.data[1])
    np.testing.assert_array_equal(w32, w16)
    t32, t16 = _f32(v32.data[0]), _f32(v16.data[0])
    m = w32 > 0
    near = m & (np.abs(t32) < 0.1)
    assert near.sum() > 500
    assert np.abs(t32[near] - t16[near]).max() < 5e-4
    assert np.abs(t32[m] - t16[m]).max() < 4.5e-3


@pytest.fixture(scope="module")
def stream_runs(scene):
    """Both packages' work-list integrate (free split on: K5 then K4) over
    three frames of a fresh bfloat16 volume."""
    torch.set_num_threads(1)
    frames, poses = scene
    jv = j_tsdf_new(RES, 3.0, TRUNC, dtype=jnp.bfloat16)
    jp = jnp.zeros(planes_shape(RES), jnp.float32)
    for d, p in zip(frames, poses):
        jv, jp = j_integrate(jax.tree_util.tree_map(jnp.copy, jv), jnp.copy(jp), jnp.asarray(d),
                             jnp.asarray(p), JINTR, interpret=True)
    tv, tp = _port_stream(frames, poses, torch.bfloat16, 3)
    return dict(j_data=_f32(jv.data), j_planes=np.asarray(jp), t_data=_f32(tv.data),
                t_planes=tp.numpy())


def test_stream_bf16_weights_identical_tsdf_one_ulp(stream_runs):
    jd, td = stream_runs["j_data"], stream_runs["t_data"]
    np.testing.assert_array_equal(td[1], jd[1])
    obs = jd[1] > 0
    assert obs.sum() > 10000 and jd[1].max() == 3
    assert _within_one_ulp(td[0], jd[0])[obs].all()
    assert (td[0] == jd[0])[obs].mean() >= 0.999


def test_stream_bf16_planes_agree(stream_runs):
    jp, tp = stream_runs["j_planes"], stream_runs["t_planes"]
    jv, tv = jp[:, :, :, 4, :] > 0.5, tp[:, :, :, 4, :] > 0.5
    assert jv.sum() > 30
    assert (jv == tv).mean() >= 0.999
    both = jv & tv
    for f in range(16):
        if f == FIELD_SAT:
            continue
        atol = 1e-4 if f in (0, 1, 2, 3, 12) else 1e-5
        np.testing.assert_allclose(tp[:, :, :, f, :][both], jp[:, :, :, f, :][both], atol=atol)
    np.testing.assert_array_equal(tp[:, :, :, FIELD_SAT], jp[:, :, :, FIELD_SAT])


def _ref_numpy(s):
    return {
        "data": s.volume.data, "origin": s.volume.origin, "voxel_size": s.volume.voxel_size,
        "trunc": s.volume.trunc, "planes": s.planes, "pose": s.pose,
        "model_maps": s.model_maps, "model_pose": s.model_pose,
        "frame_index": s.frame_index, "last_rmse": s.last_rmse, "last_corr": s.last_corr,
        "last_tracked": s.last_tracked,
    }


@pytest.mark.parametrize("use_pallas", [True, False], ids=["kernel_path", "xla_path"])
def test_step_on_bf16_matches_reference(scene, use_pallas):
    """``kinfu_step`` on a bfloat16 volume, teacher-forced: before each of
    three frames the reference's state is carried into the port
    (``state_from_numpy``: the volume by its bits), and both packages
    step. Each pose within 1e-4 and the same tracking decision; the
    weights identical on >= 99.99% of the voxels and the tsdf within one
    bfloat16 ulp on >= 99.9% of those observed alike (the two poses
    differ in their last bits, which moves the update test of a few
    voxels at the view's edges; on the first frame, fused at the shared
    initial pose, the weights are identical everywhere)."""
    frames, poses = scene
    js = j_init(JINTR, resolution=RES, size_m=3.0, trunc=TRUNC, init_pose=jnp.asarray(poses[0]),
                dtype=jnp.bfloat16)
    for k, d in enumerate(frames):
        carried = {key: np.array(v) for key, v in _ref_numpy(js).items()}
        ts = state_from_numpy(carried, device="cpu")
        assert ts.volume.data.dtype == torch.bfloat16
        js = j_step(js, jnp.asarray(d), JINTR, use_pallas=use_pallas,
                    **({"interpret": True} if use_pallas else {}))
        ts = kinfu_step(ts, torch.from_numpy(d), INTR, use_pallas=use_pallas)
        np.testing.assert_allclose(ts.pose.numpy(), np.asarray(js.pose), atol=1e-4)
        assert bool(ts.last_tracked) == bool(js.last_tracked)
        jd, td = _f32(js.volume.data), _f32(ts.volume.data)
        same_w = td[1] == jd[1]
        assert same_w.all() if k == 0 else same_w.mean() >= 0.9999
        both = (jd[1] > 0) & same_w
        assert _within_one_ulp(td[0], jd[0])[both].mean() >= 0.999


def test_reference_bf16_state_carried_in(scene):
    """A reference state on a bfloat16 volume arrives through
    ``state_from_numpy`` by its bits (numpy's ml_dtypes bfloat16 array,
    read as uint16): every cell identical."""
    frames, poses = scene
    js = j_init(JINTR, resolution=RES, size_m=3.0, trunc=TRUNC, init_pose=jnp.asarray(poses[0]),
                dtype=jnp.bfloat16)
    js = j_step(js, jnp.asarray(frames[0]), JINTR)
    carried = {k: np.array(v) for k, v in _ref_numpy(js).items()}
    assert carried["data"].dtype.name == "bfloat16"
    st = state_from_numpy(carried, device="cpu")
    assert st.volume.data.dtype == torch.bfloat16
    np.testing.assert_array_equal(st.volume.data.view(torch.int16).numpy().view(np.uint16),
                                  carried["data"].view(np.uint16))
    assert int((st.volume.data[1] > 0).sum()) > 10000


def test_from_config_bfloat16_and_fresh_volume():
    """``from_config("bfloat16")`` is the reference's fresh bfloat16
    volume: (2, X, Y, Z), tsdf +1, weight 0."""
    v = from_config(TsdfConfig(resolution=64, size_m=3.0, trunc_dist=TRUNC, dtype="bfloat16"),
                    device="cpu")
    j = j_tsdf_new(64, 3.0, TRUNC, dtype=jnp.bfloat16)
    assert v.data.dtype == torch.bfloat16 and tuple(v.data.shape) == (2, 64, 64, 64)
    np.testing.assert_array_equal(_f32(v.data), _f32(j.data))
    assert v.dims == (64, 64, 64) and not v.packed_i32


def test_dense_kernel_refuses_bf16():
    """K8 takes float32 only, as the reference asserts: a bfloat16 volume
    raises on every device rather than fuse."""
    vol = tsdf_new(RES, 3.0, TRUNC, dtype=torch.bfloat16, device="cpu")
    with pytest.raises(ValueError, match="bfloat16"):
        tsdf_integrate_with_planes(vol, torch.zeros(120, 160), torch.eye(4), INTR)


def _random_bf16_volume(rng, res):
    """A (2, res, res, res) bfloat16 volume of random observed cells: tsdf
    in [-1, 1], integer weights below 129."""
    t = rng.uniform(-1, 1, (res,) * 3).astype(np.float32)
    w = rng.integers(0, 129, (res,) * 3).astype(np.float32)
    return torch.from_numpy(np.stack([t, w])).to(torch.bfloat16)


def test_bf16_scan_checkpoint_round_trip(tmp_path):
    """A scan checkpoint of a bfloat16 state: ``save_scan_state`` writes
    the volume by its bits and ``load_scan_state`` gives back every cell
    and every other field, the fingerprint check passing."""
    from housescan_tpu_torch.kinfu.pipeline import kinfu_init, state_to_numpy
    from housescan_tpu_torch.kinfu.scan_checkpoint import load_scan_state, save_scan_state

    st = kinfu_init(INTR, resolution=64, size_m=3.0, trunc=TRUNC, dtype=torch.bfloat16,
                    device="cpu")
    st.volume.data.copy_(_random_bf16_volume(np.random.default_rng(4), 64))
    traj = np.tile(np.eye(4, dtype=np.float32), (5, 1, 1))
    path = save_scan_state(st, 5, INTR, tmp_path / "scan_checkpoint.npz", trajectory=traj)
    back, start, got_traj = load_scan_state(path, INTR, device="cpu")
    assert start == 5 and back.volume.data.dtype == torch.bfloat16
    assert torch.equal(back.volume.data.view(torch.int16), st.volume.data.view(torch.int16))
    got = state_to_numpy(back)
    for k, v in state_to_numpy(st).items():
        assert got[k].dtype == v.dtype and got[k].tobytes() == v.tobytes(), k
    np.testing.assert_array_equal(got_traj, traj)


def test_reference_bf16_scan_checkpoint_resumes_in_port(tmp_path):
    """A scan checkpoint the JAX package wrote of a bfloat16 state loads
    in the port (its volume read back by its bits, the fingerprint
    matching), every cell identical."""
    from housescan_tpu.kinfu.scan_checkpoint import save_scan_state as j_save
    from housescan_tpu_torch.kinfu.scan_checkpoint import load_scan_state

    js = j_init(JINTR, resolution=64, size_m=3.0, trunc=TRUNC, dtype=jnp.bfloat16)
    vol = _random_bf16_volume(np.random.default_rng(5), 64)
    jdata = jnp.asarray(vol.float().numpy(), jnp.bfloat16)  # exact: every value is a bfloat16
    js = js._replace(volume=js.volume._replace(data=jdata))
    path = j_save(js, 3, JINTR, tmp_path / "scan_checkpoint.npz")
    st, start, _ = load_scan_state(path, INTR, device="cpu")
    assert start == 3 and st.volume.data.dtype == torch.bfloat16
    np.testing.assert_array_equal(st.volume.data.view(torch.int16).numpy().view(np.uint16),
                                  np.asarray(jdata).view(np.uint16))
