"""The twin of ``tests/test_end_to_end.py`` on the port alone, on the CPU:
the whole cycle from depth frames to placed building models, with the
reference's assertions.

    synthetic depth streams (2 rooms)
      -> scan (fuse at known poses, surface, RANSAC planes)
      -> room directories in the reference layout
      -> load, corners, cuboid fit
      -> wall connect + position optimisation
      -> .xf export + full-resolution placed models
"""

from itertools import product

import numpy as np
import pytest
import torch

from housescan_tpu_torch.capture.replay import DepthStream
from housescan_tpu_torch.config import Config, RansacConfig, TsdfConfig
from housescan_tpu_torch.io.pcd import load_pcd
from housescan_tpu_torch.kinfu.camera import Intrinsics
from housescan_tpu_torch.kinfu.scan import scan_to_room_dir
from housescan_tpu_torch.kinfu.synthetic import furnished_room, orbit_poses, render_depth_stream
from housescan_tpu_torch.rooms import (
    Scene,
    WallRelation,
    connect_walls,
    export_all_room_xf_files,
    export_room_full_res,
    fit_cuboid_to_room,
    load_room,
    optimize_room_positions,
    suggest_corners,
    translate_room,
)
from housescan_tpu_torch.rooms.corners import accept_corner_suggestion

INTR = Intrinsics(width=160, height=120, fx=131.25, fy=131.25, cx=79.5, cy=59.5)


def two_room_poses(ri):
    """Four known-pose sweeps of room ``ri``: the walls up and down, a floor
    pass and a ceiling pass, 8 poses each."""
    sweeps = [orbit_poses(8, radius=0.25, yaw_range=6.283, pitch=p, seed=ri) for p in (0.35, -0.35)]
    sweeps.append(orbit_poses(8, radius=0.7, height=-0.6, yaw_range=6.283, pitch=-1.2, seed=ri))
    sweeps.append(orbit_poses(8, radius=0.7, height=0.6, yaw_range=6.283, pitch=1.2, seed=ri))
    return np.concatenate(sweeps)


def accept_bbox_corners(scene, room):
    """Accept, through the suggestion workflow, the suggestion nearest each
    corner of the cloud's bounding box; each must lie within 5 cm of it."""
    pts = np.asarray(room.cloud.points)
    lo, hi = pts.min(0), pts.max(0)
    for sx, sy, sz in product((0, 1), repeat=3):
        target = np.array([[lo[0], hi[0]][sx], [lo[1], hi[1]][sy], [lo[2], hi[2]][sz]])
        sid, spt = min(room.suggested_corners, key=lambda s: np.linalg.norm(s[1] - target))
        assert np.linalg.norm(spt - target) < 0.05
        room = accept_corner_suggestion(scene, room, sid)
    return room


@pytest.mark.slow
def test_full_cycle_two_scanned_rooms(tmp_path):
    """Every stage runs and is asserted; none is conditional."""
    torch.set_num_threads(1)
    cfg = Config(
        tsdf=TsdfConfig(resolution=128, size_m=3.2, trunc_dist=0.06),
        ransac=RansacConfig(min_inlier_fraction=0.01, max_planes=12, n_hypotheses=1024),
    )
    half = np.array([1.3, 1.1, 1.3], np.float32)
    _, boxes = furnished_room()

    scene = Scene(device="cpu")
    rooms = []
    for ri in range(2):
        poses = two_room_poses(ri)
        frames = render_depth_stream(INTR, poses, half, boxes=boxes, seed=ri, device="cpu")
        room_dir = scan_to_room_dir(
            DepthStream(frames=frames.numpy(), intrinsics=INTR), tmp_path / f"scan{ri}", config=cfg,
            init_pose=poses[0], use_pallas=False, downsample_to=16384, known_poses=poses,
            device="cpu",
        )
        room = suggest_corners(scene, load_room(scene, room_dir), cutoff_factor=1.3)
        assert len(room.planes) >= 6
        assert len(room.corners) == 8 or len(room.suggested_corners) >= 8
        if len(room.corners) != 8:
            room = accept_bbox_corners(scene, room)
        assert len(room.corners) == 8
        rooms.append(room)

    for i, room in enumerate(rooms):
        out = fit_cuboid_to_room(scene, room)
        assert out is not None and out[1] < 0.02, f"room {i}: rmse {out[1]}"
        rooms[i] = out[0]

    r1 = scene.rooms[rooms[1].room_id]
    scene.update_room(translate_room(r1, np.array([3.0, 0.0, 0.0], np.float32), device="cpu"))
    p0 = min(scene.rooms[rooms[0].room_id].planes, key=lambda p: p.normal[0])
    p1 = max(scene.rooms[rooms[1].room_id].planes, key=lambda p: p.normal[0])
    assert connect_walls(scene, p0.plane_id, p1.plane_id, WallRelation.opposite(0.1)) is not None
    results = optimize_room_positions(scene)
    assert len(results) >= 1
    assert all(np.isfinite(r[2]) for r in results)

    xfs = export_all_room_xf_files(scene, tmp_path / "xf")
    assert len(xfs) == 2
    for room in rooms:
        r = scene.rooms[room.room_id]
        out = export_room_full_res(r, tmp_path / f"placed{r.room_id}.pcd", device="cpu")
        assert len(load_pcd(out).points) > 1000
