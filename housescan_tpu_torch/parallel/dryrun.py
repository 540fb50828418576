"""The multi-device dry run: the port's twin of ``__graft_entry__.py``'s
``dryrun_multichip``.

``dryrun_multichip(n_devices, device=None)`` runs the four checks of the
reference's dry run on an ``n_devices`` mesh and raises AssertionError on
the first that fails:

  1. the kernel path X-sharded at 128^3 (K1, K3 once; K4, K5, K6 a slab),
     3 frames teacher-forced, each bit-exact against the single-device
     ``kinfu_step`` (pose, packed volume, persistent planes);
  2. the XLA path on float32 slabs (halo'd ray march, the finest ICP
     level psum'd over the slabs), a fused and a tracked frame;
  3. one cuboid fit a device (``fit_cuboids_sharded``);
  4. the 2 x (n/2) rooms x slabs re-fuse (``refuse_rooms_2d``), each room
     against the single-device dense integrate.

The mesh takes the visible cards (``device=None``), or repeats one named
device (``"cuda:0"``: every slab on one card; ``"cpu"``: the kernels'
plain versions).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from housescan_tpu_torch.kinfu import maps as mp
from housescan_tpu_torch.kinfu.camera import Intrinsics
from housescan_tpu_torch.kinfu.pipeline import kinfu_init, kinfu_step
from housescan_tpu_torch.kinfu.synthetic import furnished_room, orbit_poses, render_depth_stream
from housescan_tpu_torch.kinfu.tsdf import tsdf_integrate, tsdf_new
from housescan_tpu_torch.parallel.mesh import make_mesh, make_mesh2d
from housescan_tpu_torch.parallel.refuse import refuse_rooms_2d
from housescan_tpu_torch.parallel.rooms_batch import fit_cuboids_sharded
from housescan_tpu_torch.parallel.sharded import (
    make_sharded_step,
    sharded_kinfu_init,
    sharded_state_from_single,
    single_state_from_sharded,
)
from housescan_tpu_torch.solvers.cuboid_fit import cuboid_from_params


def dryrun_multichip(n_devices: int, device: Optional[str] = None) -> dict:
    """Run the four checks on an ``n_devices`` mesh (see the module
    docstring); returns their readings."""
    devices = None if device is None else [device] * n_devices
    mesh = make_mesh(n_devices, devices=devices)
    dev0 = mesh.devices[0]
    intr = Intrinsics(width=160, height=120, fx=131.25, fy=131.25, cx=79.5, cy=59.5)
    half, boxes = furnished_room()
    n_frames = 3
    poses = orbit_poses(n_frames + 1, radius=0.25, yaw_range=0.05 * n_frames, pitch=0.25)
    frames = render_depth_stream(intr, poses, half, boxes=boxes, device=dev0)

    # 1. The kernel path X-sharded at 128^3, bit-exact against one device.
    res_pallas = 128
    assert (res_pallas // 8) % n_devices == 0, (
        f"{n_devices} devices do not divide the {res_pallas}^3 X blocks")
    step_pallas = make_sharded_step(mesh, intr, iterations=(10, 5, 4), use_pallas=True)
    ref = kinfu_init(intr, resolution=res_pallas, size_m=3.0, trunc=0.06, init_pose=poses[0],
                     dtype=torch.int32, device=dev0)
    for k in range(n_frames):
        # Teacher-forced: the single-device state cut into slabs each frame.
        sh = single_state_from_sharded(
            step_pallas(sharded_state_from_single(mesh, ref, True), frames[k]), device=dev0)
        ref = kinfu_step(ref, frames[k], intr)  # in place: compare now
        assert torch.equal(sh.pose, ref.pose), (
            f"frame {k}: sharded pose != single-device (kernel path)")
        assert torch.equal(sh.volume.data, ref.volume.data), (
            f"frame {k}: sharded packed volume != single-device")
        assert torch.equal(sh.planes, ref.planes), (
            f"frame {k}: sharded persistent planes != single-device")
    pallas_valid = float((sh.model_maps[mp.MD_VALID] > 0.5).float().mean())
    assert pallas_valid > 0.1, "sharded tile raycast produced no model"

    # 2. The XLA path on slabs (a volume that need not tile).
    resolution = max(8 * n_devices, 64)
    state = sharded_kinfu_init(mesh, intr, resolution=resolution, size_m=3.0, trunc=0.1,
                               init_pose=poses[0])
    step = make_sharded_step(mesh, intr, max_raycast_steps=48)
    state = step(state, frames[0])
    state = step(state, frames[1])  # a tracked frame
    assert int(state.frame_index) == 2
    model_valid = state.model_maps[mp.MD_VALID] > 0.5
    assert bool(model_valid.any()), "sharded ray march produced no model"

    # 3. One cuboid fit a device.
    rng = np.random.default_rng(0)
    params = np.stack([np.concatenate([rng.uniform(-2, 2, 3), rng.uniform(2, 5, 3),
                                       rng.normal(size=4)]) for _ in range(n_devices)])
    batch = cuboid_from_params(torch.as_tensor(params, dtype=torch.float32))
    fit = fit_cuboids_sharded(batch, mesh)
    max_fit_err = float(fit.error.max())
    assert max_fit_err < 1e-3, "sharded cuboid fit failed"

    # 4. Rooms x slabs: the 2-D re-fuse against the single-device integrate.
    n_rooms_2d = 2
    n_slabs_2d = n_devices // n_rooms_2d
    mesh2d = make_mesh2d(n_rooms_2d, n_slabs_2d,
                         devices=None if device is None else [device] * n_devices)
    host_frames = frames.cpu().numpy()
    streams2d = [host_frames[:2], host_frames[1:3]]
    trajs2d = [poses[:2], poses[1:3]]
    vols2d = refuse_rooms_2d(mesh2d, streams2d, trajs2d, intr, resolution=64, size_m=3.0,
                             trunc=0.1)
    for r in range(n_rooms_2d):
        ref2d = tsdf_new(64, 3.0, 0.1, device=dev0)
        for k in range(2):
            tsdf_integrate(ref2d, torch.as_tensor(streams2d[r][k], device=dev0),
                           torch.as_tensor(np.asarray(trajs2d[r][k], np.float32), device=dev0),
                           intr)
        vol = vols2d[r]
        assert torch.equal(vol.weight.to(dev0), ref2d.weight), (
            f"2-D re-fuse room {r}: weights != single-device")
        assert torch.equal(vol.tsdf.to(dev0), ref2d.tsdf), (
            f"2-D re-fuse room {r}: tsdf != single-device")

    readings = dict(n_devices=n_devices, devices=sorted({str(d) for d in mesh.devices}),
                    pallas_valid=pallas_valid,
                    xla_resolution=resolution, xla_valid=float(model_valid.float().mean()),
                    max_cuboid_fit_err=max_fit_err, refuse_mesh=[n_rooms_2d, n_slabs_2d])
    print(
        f"dryrun_multichip OK: {n_devices} devices {readings['devices']}; the kernel path at "
        f"{res_pallas}^3 X-sharded, {n_frames} frames bit-exact against one device (pose, "
        f"volume, planes), model_valid={pallas_valid:.3f}; XLA path {resolution}^3 "
        f"model_valid={readings['xla_valid']:.3f}; max cuboid fit err={max_fit_err:.2e}; "
        f"{n_rooms_2d}x{n_slabs_2d} rooms x slabs re-fuse exact"
    )
    return readings
