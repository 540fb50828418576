"""The port's XLA fusion path against the reference end to end: the step,
the closed loop, the scan at a resolution that does not tile, and float32
scan checkpoints.

The reference runs ``kinfu_step(use_pallas=False)`` on the CPU (jitted
XLA, its CPU solve branch) on the float32 (2, X, Y, Z) volume, as its own
tests and its scan do. Streams: the furnished-room orbit at 160x120 (the
reference's test streams). Bounds, and why:

  * one step from a carried state: every pose entry within 1e-5 (three
    ICP levels of 1e-5-class iterations, ``tests/test_torch_xla.py``;
    measured 2.3e-8), the same tracking decision, model-map valid masks on
    >= 99.5% of pixels;
  * the closed loop (10 frames, 128^3): the reference test's own bounds
    (< 8 mm, > 3000 correspondences) and the port's final position within
    0.5 mm of the reference's (measured 5e-4 mm);
  * scans: per frame within 1e-4 (the step bound with margin for six
    frames; measured 3.1e-6).
"""

import dataclasses

import pytest

pytest.importorskip("jax")

import jax.numpy as jnp
import numpy as np
import torch

from housescan_tpu.kinfu.camera import Intrinsics as JIntrinsics
from housescan_tpu.kinfu.pipeline import kinfu_init as j_init
from housescan_tpu.kinfu.pipeline import kinfu_step as j_step
from housescan_tpu_torch.capture.replay import load_stream, record_stream
from housescan_tpu_torch.config import Config, TsdfConfig
from housescan_tpu_torch.kinfu.camera import Intrinsics
from housescan_tpu_torch.kinfu.pipeline import (
    STATE_FIELDS,
    kinfu_init,
    kinfu_run,
    kinfu_step,
    pallas_supported,
    state_from_numpy,
    state_to_numpy,
)
from housescan_tpu_torch.kinfu.scan import scan_to_room_dir
from housescan_tpu_torch.kinfu.scan_checkpoint import (
    _state_fingerprint,
    load_scan_state,
    save_scan_state,
)
from housescan_tpu_torch.kinfu.synthetic import furnished_room, orbit_poses, render_depth_stream
from housescan_tpu_torch.ops import cuda_lib

INTR = Intrinsics(width=160, height=120, fx=131.25, fy=131.25, cx=79.5, cy=59.5)
JINTR = JIntrinsics(*INTR)
N_LOOP = 10
SCAN_RES = 96  # does not tile into 128-voxel chunks
SCAN_CFG = Config(tsdf=TsdfConfig(resolution=SCAN_RES, size_m=3.0, trunc_dist=0.06))


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _fields(s):
    return {
        "data": s.volume.data, "origin": s.volume.origin,
        "voxel_size": s.volume.voxel_size, "trunc": s.volume.trunc,
        "planes": s.planes, "pose": s.pose, "model_maps": s.model_maps,
        "model_pose": s.model_pose, "frame_index": s.frame_index,
        "last_rmse": s.last_rmse, "last_corr": s.last_corr,
        "last_tracked": s.last_tracked,
    }


@pytest.fixture(scope="module")
def loop():
    """The reference's 10-frame closed loop at 128^3 (its
    ``test_tracking_short_sweep`` workload): per-frame poses, its state
    after frame 2 (numpy) and its frame-3 state."""
    torch.set_num_threads(1)
    half, boxes = furnished_room()
    poses = np.array(orbit_poses(N_LOOP, radius=0.25, yaw_range=np.pi / 16, pitch=0.25))
    frames = render_depth_stream(INTR, poses, half, boxes, device="cpu")
    st = j_init(JINTR, resolution=128, size_m=3.0, trunc=0.06, init_pose=jnp.asarray(poses[0]))
    traj, after2, third = [], None, None
    for i in range(N_LOOP):
        st = j_step(st, jnp.asarray(frames[i].numpy()), JINTR)
        traj.append(np.array(st.pose))
        if i == 2:
            third = {k: np.array(v) for k, v in _fields(st).items()}
        if i == 1:
            after2 = {k: np.array(v) for k, v in _fields(st).items()}
    return dict(poses=poses, frames=frames, traj=np.stack(traj), after2=after2, third=third,
                last_corr=int(st.last_corr))


def test_step_matches_reference_from_carried_state(loop):
    """The reference's float32 state after frames 0-1, carried with
    ``state_from_numpy``; frame 2 through one step in each package."""
    st = state_from_numpy(loop["after2"], device="cpu")
    assert st.volume.data.dtype == torch.float32
    cuda_lib.reset_counts()
    st = kinfu_step(st, loop["frames"][2], INTR, use_pallas=False)
    want = loop["third"]
    assert bool(st.last_tracked) == bool(want["last_tracked"])
    np.testing.assert_allclose(st.pose.numpy(), want["pose"], atol=1e-5)
    assert abs(int(st.last_corr) - int(want["last_corr"])) <= max(5, int(want["last_corr"]) // 200)
    tv = st.model_maps[7].numpy() > 0.5
    jv = want["model_maps"][7] > 0.5
    assert jv.sum() > 10000 and (tv == jv).mean() >= 0.995
    np.testing.assert_array_equal(st.volume.weight.numpy(), want["data"][1])
    assert int(st.frame_index) == 3
    assert cuda_lib.plain_counts["bilateral"] == 1 and cuda_lib.plain_counts["solve6"] == 19
    assert all(cuda_lib.plain_counts[k] == 0 for k in cuda_lib.KERNEL_PATH if k not in cuda_lib.XLA_PATH)


def test_tracking_short_sweep(loop):
    """Twin of the reference's ``TestPipeline.test_tracking_short_sweep``
    (10 frames, 128^3, the XLA path) in the port: < 8 mm, > 3000
    correspondences, and the final position within 0.5 mm of the
    reference's."""
    poses = loop["poses"]
    st = kinfu_init(INTR, resolution=128, size_m=3.0, trunc=0.06, init_pose=poses[0],
                    dtype=torch.float32, device="cpu")
    st, est = kinfu_run(st, loop["frames"], INTR, iterations=(10, 5, 4), use_pallas=False)
    est = est.numpy()
    assert np.linalg.norm(est[-1][3, :3] - poses[-1][3, :3]) < 0.008
    assert int(st.frame_index) == N_LOOP
    assert int(st.last_corr) > 3000
    assert np.linalg.norm(est[-1][3, :3] - loop["traj"][-1][3, :3]) < 5e-4


def test_packed_volume_steps_on_xla_path(loop):
    """The XLA path takes the packed layout as the reference does: three
    frames at 96^3 track like the float volume (poses within 1e-4, the
    layouts differing by the tsdf quantization)."""
    poses, frames = loop["poses"], loop["frames"]
    out = []
    for dtype in (torch.int32, torch.float32):
        st = kinfu_init(INTR, resolution=SCAN_RES, size_m=3.0, trunc=0.06, init_pose=poses[0],
                        dtype=dtype, device="cpu")
        st, traj = kinfu_run(st, frames[:3], INTR, use_pallas=False)
        assert st.volume.data.dtype == dtype
        out.append(traj.numpy())
    np.testing.assert_allclose(out[0], out[1], atol=1e-4)


def test_float_state_round_trip(loop):
    d = state_to_numpy(state_from_numpy(loop["after2"], device="cpu"))
    assert set(d) == set(STATE_FIELDS)
    for k in STATE_FIELDS:
        np.testing.assert_array_equal(d[k], loop["after2"][k])
        assert d[k].dtype == loop["after2"][k].dtype


# --- the scan on the XLA path ----------------------------------------------


@pytest.fixture(scope="module")
def stream_file(tmp_path_factory):
    """Twin of ``test_capture_scan.py``'s 6-frame recorded stream."""
    half, boxes = furnished_room()
    poses = orbit_poses(6, radius=0.25, yaw_range=0.1, pitch=0.25)
    frames = render_depth_stream(INTR, poses, half, boxes, device="cpu")
    path = tmp_path_factory.mktemp("streams") / "scan.npz"
    record_stream(path, frames, INTR, poses=poses)
    return path, poses


@pytest.fixture(scope="module")
def ref_scans(stream_file, tmp_path_factory):
    """The reference's scans of the stream at 96^3: the whole stream, and
    the first 3 frames with a checkpoint every 2 frames (float32)."""
    from housescan_tpu.capture.replay import load_stream as j_load_stream
    from housescan_tpu.config import Config as JConfig
    from housescan_tpu.config import TsdfConfig as JTsdfConfig
    from housescan_tpu.kinfu.scan import scan_to_room_dir as j_scan

    torch.set_num_threads(1)
    path, poses = stream_file
    root = tmp_path_factory.mktemp("ref_rooms")
    cfg = JConfig(tsdf=JTsdfConfig(resolution=SCAN_RES, size_m=3.0, trunc_dist=0.06))
    stream = j_load_stream(path)
    kw = dict(config=cfg, init_pose=poses[0], downsample_to=4096)
    full = j_scan(stream, root / "full", **kw)
    head = dataclasses.replace(stream, frames=stream.frames[:3])
    j_scan(head, root / "head", checkpoint_every=2, **kw)
    return dict(traj=np.load(full / "trajectory.npz")["poses"],
                ckpt=root / "head" / "scan_checkpoint.npz")


def test_scan_produces_reference_layout(stream_file, ref_scans, tmp_path):
    """Twin of ``TestScanBridge.test_scan_produces_reference_layout`` at
    96^3: the scan takes the XLA path unasked, writes the reference
    layout, the reference's room stage loads it, and its trajectory
    follows the reference's scan."""
    path, poses = stream_file
    assert not pallas_supported(SCAN_RES)
    cuda_lib.reset_counts()
    out = scan_to_room_dir(load_stream(path), tmp_path / "room_scan", config=SCAN_CFG,
                           init_pose=poses[0], downsample_to=8192, device="cpu")
    assert cuda_lib.plain_counts["solve6"] > 0 and cuda_lib.plain_counts["bilateral"] == 6
    assert all(cuda_lib.plain_counts[k] == 0 for k in cuda_lib.KERNEL_PATH if k not in cuda_lib.XLA_PATH)
    for name in ("cloud_downsampled.pcd", "cloud_bin.pcd", "planes.txt", "cloud_plane_hull0.pcd",
                 "trajectory.npz"):
        assert (out / name).exists(), name
    np.testing.assert_allclose(np.load(out / "trajectory.npz")["poses"], ref_scans["traj"],
                               atol=1e-4)

    from housescan_tpu.rooms import Scene, load_room

    room = load_room(Scene(), out)
    assert len(room.cloud.points) > 1000
    assert len(room.planes) >= 2
    center = room.mean()
    for p in room.planes:
        assert float(np.dot(center - p.mean(), p.normal)) > 0


def test_reference_float_checkpoint_resumes_in_port(stream_file, ref_scans, tmp_path):
    """A float32 checkpoint the reference's scan wrote at frame 2 resumes
    in the port's scan on the XLA path; the trajectory keeps the
    checkpoint's rows bit for bit and follows the reference's
    uninterrupted scan."""
    path, _ = stream_file
    st, nxt, traj = load_scan_state(ref_scans["ckpt"], INTR, device="cpu")
    assert nxt == 2 and st.volume.data.dtype == torch.float32 and st.volume.data.dim() == 4
    assert "volume:data,origin,voxel_size,trunc:4d:float32" in _state_fingerprint(st)
    out = tmp_path / "resumed"
    out.mkdir()
    (out / "scan_checkpoint.npz").write_bytes(ref_scans["ckpt"].read_bytes())
    scan_to_room_dir(load_stream(path), out, config=SCAN_CFG, downsample_to=4096, resume=True,
                     device="cpu")
    got = np.load(out / "trajectory.npz")["poses"]
    np.testing.assert_array_equal(got[:2], traj)
    np.testing.assert_allclose(got, ref_scans["traj"], atol=1e-4)


def test_float_checkpoint_round_trips(loop, tmp_path):
    """A port-written float32 v4 checkpoint loads back bit for bit, in the
    port and in the reference."""
    from housescan_tpu.kinfu.scan_checkpoint import _state_fingerprint as j_fingerprint
    from housescan_tpu.kinfu.scan_checkpoint import load_scan_state as j_load

    st = state_from_numpy(loop["after2"], device="cpu")
    traj = loop["traj"][:2]
    save_scan_state(st, 2, INTR, tmp_path / "f32.npz", trajectory=traj)
    back, nxt, btraj = load_scan_state(tmp_path / "f32.npz", INTR, device="cpu")
    assert nxt == 2
    np.testing.assert_array_equal(btraj, traj)
    for k, v in state_to_numpy(back).items():
        np.testing.assert_array_equal(v, loop["after2"][k])
        assert v.dtype == loop["after2"][k].dtype
    js, _, _ = j_load(tmp_path / "f32.npz", JINTR)
    assert j_fingerprint(js) == _state_fingerprint(back)
    np.testing.assert_array_equal(np.asarray(js.volume.data), loop["after2"]["data"])
