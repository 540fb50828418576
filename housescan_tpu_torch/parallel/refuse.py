"""Rooms re-fused side by side, each room's volume in X-slabs: the 2-D
(rooms x slabs) mesh of ``housescan_tpu/parallel/refuse.py``.

The offline re-fuse of recorded streams at their recorded poses: pure
integration, no tracking, so every (room, slab) tile fuses on its own
device without talking to any other. Each tile runs the single-device
XLA path's dense integrate (``kinfu/tsdf.tsdf_integrate``) on its slab
with the whole volume's origin and the slab's first X plane, so each room
is the single-device fusion bit for bit (the reference's tile takes a
slab-local origin, which rounds the voxel centres differently)."""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

from housescan_tpu_torch.kinfu.camera import Intrinsics
from housescan_tpu_torch.kinfu.tsdf import TsdfVolume, fresh_data, tsdf_integrate
from housescan_tpu_torch.parallel.mesh import Mesh
from housescan_tpu_torch.parallel.sharded import ShardedVolume


def refuse_rooms_2d(
    mesh2d: Mesh,
    streams: Sequence[np.ndarray],
    trajectories: Sequence[np.ndarray],
    intr: Intrinsics,
    resolution: int = 128,
    size_m: float = 3.0,
    trunc: float = 0.06,
    max_weight: float = 128.0,
) -> List[TsdfVolume]:
    """Fuse R recorded (N, H, W) streams at their (N, 4, 4) poses, room r
    X-slabbed over row r of the (R, S) mesh. Returns the R float32
    volumes, each gathered on its row's first device. Every stream has N
    frames (pad a short one with zero frames: an all-invalid depth fuses
    nothing)."""
    n_rooms, n_slabs = mesh2d.shape
    if len(streams) != n_rooms or len(trajectories) != n_rooms:
        raise ValueError(f"{len(streams)} streams / {len(trajectories)} trajectories for a "
                         f"{n_rooms}-room mesh")
    n_frames = len(streams[0])
    if any(len(s) != n_frames for s in streams):
        raise ValueError("all streams must share one length (pad with zeros)")
    if resolution % n_slabs:
        raise ValueError(f"{resolution} X-planes do not split over {n_slabs} slabs")
    shape = (resolution // n_slabs, resolution, resolution)
    rooms = []
    for r in range(n_rooms):
        row = mesh2d.row(r)
        dev0 = row.devices[0]
        rooms.append(ShardedVolume(
            slabs=[fresh_data(shape, torch.float32, d) for d in row.devices],
            origin=torch.full((3,), -size_m / 2.0, dtype=torch.float32, device=dev0),
            voxel_size=torch.tensor(size_m / resolution, dtype=torch.float32, device=dev0),
            trunc=torch.tensor(trunc, dtype=torch.float32, device=dev0),
        ))
    for k in range(n_frames):
        for vol, stream, traj in zip(rooms, streams, trajectories):
            depth = torch.as_tensor(np.asarray(stream[k], np.float32))
            pose = torch.as_tensor(np.asarray(traj[k], np.float32))
            for i, slab in enumerate(vol.slabs):
                tsdf_integrate(vol.slab(i), depth.to(slab.device), pose.to(slab.device), intr,
                               max_weight=max_weight, x_offset=i * shape[0])
    return [vol.gather() for vol in rooms]
