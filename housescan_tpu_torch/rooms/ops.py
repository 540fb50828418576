"""Rigid motions of rooms, and the ceiling cut.

A port of ``housescan_tpu/rooms/ops.py``: rotate, translate and project a
room (cloud, plane equations and bounds, corners, the cumulative
``proj``), and drop its top points. Rooms stay host numpy; the array math
runs on ``device`` (default the card). A rotation moves every point of
the room (cloud, plane bounds, corners) in one transfer and one matmul.

float64 must not leak in: every array goes to the device through
``geometry.transform.f32``, which makes it float32 as ``jnp.asarray``
does.
"""

from __future__ import annotations

import math
from dataclasses import replace
from typing import List

import numpy as np
import torch

from housescan_tpu_torch.geometry.plane import (
    PlaneEq,
    rotate_plane_eq_around,
    translate_plane_eq,
)
from housescan_tpu_torch.geometry.transform import (
    axis_angle_mat,
    compose_proj4,
    f32,
    on_device,
    rotate_around,
    rotation_proj4_around,
)
from housescan_tpu_torch.rooms.types import Plane, Room
from housescan_tpu_torch.utils.vector_util import top_fraction_threshold


def plane_arrays(room: Room, device) -> PlaneEq:
    """The room's plane equations as one batched float32 PlaneEq."""
    normals = np.stack([p.normal for p in room.planes]) if room.planes else np.zeros((0, 3))
    return PlaneEq(f32(normals, device), f32([p.d for p in room.planes], device))


def _with_plane_eqs(room: Room, eq: PlaneEq, new_bounds: List[np.ndarray]) -> List[Plane]:
    normals, ds = eq.normal.cpu().numpy(), eq.d.cpu().numpy()
    return [
        replace(p, normal=normals[i], d=float(ds[i]), bounds=new_bounds[i])
        for i, p in enumerate(room.planes)
    ]


def _split(points: np.ndarray, sizes: List[int]) -> List[np.ndarray]:
    return np.split(points, np.cumsum(sizes)[:-1]) if sizes else []


def rotate_room_around(room: Room, center: np.ndarray, rot_mat: np.ndarray, *, device="cuda") -> Room:
    """Rotate every component of a room about ``center``; the cumulative
    proj picks up T(-c) R T(c)."""
    device = on_device(device)
    c, rot = f32(center, device), f32(rot_mat, device)

    # cloud, every plane's bounds and both corner lists in one matmul
    parts = [room.cloud.points] + [p.bounds for p in room.planes]
    parts += [np.stack([x for _, x in cs]) for cs in (room.corners, room.suggested_corners) if cs]
    sizes = [len(x) for x in parts]
    moved = rotate_around(c, rot, f32(np.concatenate(parts), device)).cpu().numpy()
    moved = _split(moved, sizes)
    points, bounds, rest = moved[0], moved[1:1 + len(room.planes)], moved[1 + len(room.planes):]
    # a plane without bounds keeps its empty array
    bounds = [b if len(p.bounds) else p.bounds for b, p in zip(bounds, room.planes)]
    planes = (_with_plane_eqs(room, rotate_plane_eq_around(plane_arrays(room, device), c, rot), bounds)
              if room.planes else [])

    def corners_of(cs):
        if not cs:
            return []
        out = rest.pop(0)
        return [(i, out[k]) for k, (i, _) in enumerate(cs)]

    corners = corners_of(room.corners)
    suggested = corners_of(room.suggested_corners)
    proj = compose_proj4(f32(room.proj, device), rotation_proj4_around(c, rot)).cpu().numpy()
    return replace(
        room,
        cloud=replace(room.cloud, points=points),
        planes=planes,
        corners=corners,
        suggested_corners=suggested,
        proj=proj,
    )


def rotate_room(room: Room, rot_mat: np.ndarray, *, device="cuda") -> Room:
    """Rotate about the room's cloud mean."""
    return rotate_room_around(room, room.mean(), rot_mat, device=device)


def translate_room(room: Room, offset: np.ndarray, *, device="cuda") -> Room:
    """Translate every component: the plane equations on ``device``, the
    points on the host (an addition, as the reference does it)."""
    device = on_device(device)
    off = np.asarray(offset, np.float32)
    if room.planes:
        eq = translate_plane_eq(plane_arrays(room, device), f32(off, device))
        planes = _with_plane_eqs(
            room, eq, [p.bounds + off if len(p.bounds) else p.bounds for p in room.planes]
        )
    else:
        planes = []
    proj = room.proj.copy()
    proj[3, :3] = proj[3, :3] + off  # T(off) right-composed onto an affine proj
    return replace(
        room,
        cloud=replace(room.cloud, points=room.cloud.points + off),
        planes=planes,
        corners=[(i, c + off) for i, c in room.corners],
        suggested_corners=[(i, c + off) for i, c in room.suggested_corners],
        proj=proj,
    )


def project_room(room: Room, proj: np.ndarray, *, device="cuda") -> Room:
    """Apply a rigid row-vector 4x4 and compose it into the room's proj:
    rotate about the origin, then translate; the proj is then set to the
    exact one-step composition."""
    device = on_device(device)
    proj = np.asarray(proj, np.float32)
    rotated = rotate_room_around(room, np.zeros(3, np.float32), proj[:3, :3], device=device)
    moved = translate_room(rotated, proj[3, :3], device=device)
    return replace(moved, proj=compose_proj4(f32(room.proj, device), f32(proj, device)).cpu().numpy())


def rotate_kinfu_room(room: Room, *, device="cuda") -> Room:
    """KinFu-recorded clouds are heads-up: turn 180 degrees about X."""
    device = on_device(device)
    rot = axis_angle_mat(torch.tensor([1.0, 0.0, 0.0], device=device), math.pi)
    return rotate_room(room, rot.cpu().numpy(), device=device)


def remove_ceiling(room: Room, fraction: float = 0.2, *, device="cuda") -> Room:
    """Drop the top ``fraction`` of points by Y (to look inside); per-point
    colours stay aligned."""
    pts = room.cloud.points
    if len(pts) == 0:
        return room
    y_limit = float(top_fraction_threshold(f32(pts[:, 1], device), fraction))
    keep = pts[:, 1] <= y_limit
    new_cloud = replace(room.cloud, points=pts[keep])
    if room.cloud.colors is not None and len(room.cloud.colors):
        new_cloud = replace(new_cloud, colors=room.cloud.colors[keep])
    return replace(room, cloud=new_cloud)
