"""The port's whole fusion step against the reference, and its closed loop.

One reference state, two frames into the furnished-room orbit (Pallas
kernels in interpret mode, a 128^3 volume of each layout: packed int32
and float32, the reference's default, 160x120), is carried into the port
with ``state_from_numpy``; the next frame then goes through one
``kinfu_step`` in each package. Bounds: every pose entry within 1e-4 (the
level bound of the ICP parity, 5e-5, over three levels), the same
tracking decision, and model-map valid masks agreeing on >= 99% of
pixels.
"""

import inspect
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from housescan_tpu_torch.kinfu.camera import Intrinsics
from housescan_tpu_torch.kinfu.pipeline import (
    STATE_FIELDS,
    kinfu_init,
    kinfu_run,
    kinfu_step,
    state_from_numpy,
    state_to_numpy,
)
from housescan_tpu_torch.kinfu.synthetic import furnished_room, orbit_poses, render_depth_stream
from housescan_tpu_torch.ops import cuda_lib

INTR = Intrinsics(width=160, height=120, fx=131.25, fy=131.25, cx=79.5, cy=59.5)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def stream():
    half, boxes = furnished_room()
    poses = orbit_poses(10, radius=0.25, yaw_range=np.pi / 16, pitch=0.25)
    frames = render_depth_stream(INTR, poses, half, boxes, device="cpu")
    return poses, frames


def _ref_state_numpy(s):
    return {
        "data": s.volume.data, "origin": s.volume.origin,
        "voxel_size": s.volume.voxel_size, "trunc": s.volume.trunc,
        "planes": s.planes, "pose": s.pose, "model_maps": s.model_maps,
        "model_pose": s.model_pose, "frame_index": s.frame_index,
        "last_rmse": s.last_rmse, "last_corr": s.last_corr,
        "last_tracked": s.last_tracked,
    }


@pytest.mark.parametrize("layout", ["packed", "float32"])
def test_step_matches_reference_from_carried_state(stream, layout):
    pytest.importorskip("jax")
    import jax.numpy as jnp

    from housescan_tpu.kinfu.camera import Intrinsics as JIntrinsics
    from housescan_tpu.kinfu.pipeline import kinfu_init as j_init
    from housescan_tpu.kinfu.pipeline import kinfu_step as j_step

    poses, frames = stream
    jintr = JIntrinsics(*INTR)
    frames_np = frames.numpy()
    js = j_init(jintr, resolution=128, size_m=3.0, trunc=0.06, init_pose=jnp.asarray(poses[0]),
                **({"dtype": jnp.int32} if layout == "packed" else {}))
    for i in range(2):
        js = j_step(js, jnp.asarray(frames_np[i]), jintr, use_pallas=True, interpret=True)
    # kinfu_step donates its input state: copy to numpy first
    carried = {k: np.array(v) for k, v in _ref_state_numpy(js).items()}
    js = j_step(js, jnp.asarray(frames_np[2]), jintr, use_pallas=True, interpret=True)

    ts = kinfu_step(state_from_numpy(carried, device="cpu"), frames[2], INTR)
    assert ts.volume.packed_i32 == (layout == "packed")
    assert bool(ts.last_tracked) == bool(js.last_tracked)
    np.testing.assert_allclose(ts.pose.numpy(), np.asarray(js.pose), atol=1e-4)
    tv = ts.model_maps[7].numpy() > 0.5
    jv = np.asarray(js.model_maps)[7] > 0.5
    assert jv.sum() > 5000
    assert (tv == jv).mean() >= 0.99
    assert int(ts.frame_index) == int(js.frame_index) == 3


def test_state_round_trip(stream):
    poses, frames = stream
    st = kinfu_init(INTR, resolution=128, size_m=3.0, trunc=0.06, init_pose=poses[0], device="cpu")
    st = kinfu_step(st, frames[0], INTR)
    d = state_to_numpy(st)
    assert set(d) == set(STATE_FIELDS)
    back = state_to_numpy(state_from_numpy(d, device="cpu"))
    for k in STATE_FIELDS:
        np.testing.assert_array_equal(back[k], d[k])
        assert back[k].dtype == d[k].dtype


def test_tracking_closed_loop(stream):
    """Port-only twin of the reference's closed-loop drift bound at this
    doubly harsh configuration (23 mm voxels, 160x120): < 20 mm after
    six tracked frames."""
    poses, frames = stream
    cuda_lib.reset_counts()
    st = kinfu_init(INTR, resolution=128, size_m=3.0, trunc=0.06, init_pose=poses[0], device="cpu")
    st, traj = kinfu_run(st, frames[:7], INTR)
    err = np.linalg.norm(st.pose[3, :3].numpy() - poses[6][3, :3])
    assert err < 0.020, f"closed-loop drift {err * 1000:.1f} mm over 6 frames"
    assert traj.shape == (7, 4, 4)
    assert bool(st.last_tracked) and int(st.last_corr) > 1000
    # on the CPU every kernel wrapper of the kernel path took its plain
    # version; the XLA path's solve (K2) did not run
    assert all(cuda_lib.plain_counts[k] > 0 for k in cuda_lib.KERNEL_PATH)
    assert all(cuda_lib.launch_counts[k] == 0 for k in cuda_lib.KERNELS)
    assert cuda_lib.plain_counts["solve6"] == 0


def test_tracking_loss_drops_frame(stream):
    """A teleported view is dropped: pose, volume, planes and model
    unchanged, last_tracked False; the next good frame re-tracks."""
    poses, frames = stream
    st = kinfu_init(INTR, resolution=128, size_m=3.0, trunc=0.06, init_pose=poses[0], device="cpu")
    for i in range(2):
        st = kinfu_step(st, frames[i], INTR)
    assert bool(st.last_tracked)
    half, boxes = furnished_room()
    far = orbit_poses(2, radius=0.4, yaw_range=np.pi)[1:]
    bad = render_depth_stream(INTR, far, half, boxes, device="cpu")[0]
    before = {k: v.copy() for k, v in state_to_numpy(st).items()}
    st = kinfu_step(st, bad, INTR)
    assert not bool(st.last_tracked)
    for k in ("pose", "data", "planes", "model_maps"):
        np.testing.assert_array_equal(state_to_numpy(st)[k], before[k])
    st = kinfu_step(st, frames[2], INTR)
    assert bool(st.last_tracked)
    assert np.linalg.norm(st.pose[3, :3].numpy() - poses[2][3, :3]) < 0.02


def test_step_rejects_untileable_volume(stream):
    """The kernel path needs a volume that tiles into 128-voxel chunks,
    in either layout (the XLA path takes it:
    ``tests/test_torch_xla_loop.py``); a tileable float32 volume steps."""
    _, frames = stream
    for dtype in (torch.int32, torch.float32):
        st = kinfu_init(INTR, resolution=96, dtype=dtype, device="cpu")
        with pytest.raises(ValueError):
            kinfu_step(st, frames[0], INTR, use_pallas=True)
    st = kinfu_init(INTR, resolution=128, device="cpu")
    assert st.volume.data.dtype == torch.float32
    st = kinfu_step(st, frames[0], INTR, use_pallas=True)
    assert float(st.volume.weight.max()) == 1.0


def test_entry_points_default_to_the_card():
    """The port's entry points put their tensors on CUDA unless the
    caller asks for the CPU (read without a card, from the signatures)."""
    from housescan_tpu_torch.kinfu.scan import scan_to_room_dir
    from housescan_tpu_torch.kinfu.scan_checkpoint import load_scan_state
    from housescan_tpu_torch.kinfu.tsdf import tsdf_new

    for fn in (kinfu_init, state_from_numpy, scan_to_room_dir, load_scan_state, tsdf_new,
               render_depth_stream):
        assert inspect.signature(fn).parameters["device"].default == "cuda", fn.__name__


def test_forced_pose_skips_tracking(stream):
    """A known pose is fused as given: no ICP (rmse and correspondences
    0), always integrated, even for a view tracking would drop."""
    poses, frames = stream
    st = kinfu_init(INTR, resolution=128, size_m=3.0, trunc=0.06, init_pose=poses[0], device="cpu")
    st = kinfu_step(st, frames[0], INTR)
    half, boxes = furnished_room()
    far = orbit_poses(2, radius=0.4, yaw_range=np.pi)[1]
    bad = render_depth_stream(INTR, far[None], half, boxes, device="cpu")[0]
    st = kinfu_step(st, bad, INTR, forced_pose=far)
    assert bool(st.last_tracked)
    np.testing.assert_array_equal(st.pose.numpy(), far)
    np.testing.assert_array_equal(st.model_pose.numpy(), far)
    assert float(st.last_rmse) == 0.0 and int(st.last_corr) == 0


def test_port_imports_no_jax():
    code = (
        "import sys\n"
        "import housescan_tpu_torch\n"
        "import housescan_tpu_torch.kinfu.pipeline, housescan_tpu_torch.kinfu.synthetic\n"
        "import housescan_tpu_torch.ops.cuda_lib\n"
        "import housescan_tpu_torch.config, housescan_tpu_torch.capture.replay\n"
        "import housescan_tpu_torch.io.pcd, housescan_tpu_torch.io.ply, housescan_tpu_torch.io.planes_txt\n"
        "import housescan_tpu_torch.geometry.plane, housescan_tpu_torch.geometry.fitting\n"
        "import housescan_tpu_torch.kinfu.ransac, housescan_tpu_torch.kinfu.marching_cubes\n"
        "import housescan_tpu_torch.kinfu.scan_checkpoint, housescan_tpu_torch.kinfu.scan\n"
        "import housescan_tpu_torch.kinfu.raycast, housescan_tpu_torch.ops.solve6\n"
        "import housescan_tpu_torch.ops.tsdf_cuda, housescan_tpu_torch.ops.planes_cuda\n"
        "from housescan_tpu_torch.ops import tsdf_integrate_pallas\n"
        "import housescan_tpu_torch.rooms, housescan_tpu_torch.solvers, housescan_tpu_torch.utils\n"
        "import housescan_tpu_torch.geometry, housescan_tpu_torch.io.xf, housescan_tpu_torch.testing\n"
        "import housescan_tpu_torch.parallel, housescan_tpu_torch.kinfu.building\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'housescan_tpu.'))"
        " or m == 'housescan_tpu' or m.split('.')[0] == 'ml_dtypes']\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
