"""Room auto-alignment to world axes.

Capability parity with roomAutoAlignAxis / autoAlignFloor
(ref Main.hs:1895-1910): pick the plane whose normal is most parallel to
the target axis and rotate the whole room so that plane faces exactly
along it. A port of ``housescan_tpu/rooms/align.py``: the rotations are
computed on ``scene.device`` (or ``device``).
"""

from __future__ import annotations

from dataclasses import replace
from typing import Optional

import numpy as np

from housescan_tpu_torch.geometry.plane import PlaneEq, flip_plane_eq, rotate_plane_eq_around
from housescan_tpu_torch.geometry.transform import f32, on_device, rotate_around, rotation_between_normals
from housescan_tpu_torch.rooms.ops import rotate_room
from housescan_tpu_torch.rooms.types import Room, Scene


def room_auto_align_axis(scene: Scene, room: Room, axis: np.ndarray) -> Optional[Room]:
    """Align the room plane most parallel to ``axis`` exactly onto it
    (ref Main.hs:1895-1905). Returns None if the room has no planes."""
    if not room.planes:
        return None
    dots = [float(np.dot(axis, p.normal)) for p in room.planes]
    floor_plane = room.planes[int(np.argmax(dots))]
    device = on_device(scene.device)
    rot = rotation_between_normals(f32(floor_plane.normal, device), f32(axis, device))
    new_room = rotate_room(room, rot.cpu().numpy(), device=device)
    scene.update_room(new_room)
    return new_room


def auto_align_floor(scene: Scene, room: Room) -> Optional[Room]:
    """Align the floor (most +Y-facing plane, inward normals point up from
    the floor) to +Y (ref Main.hs:1908-1910)."""
    return room_auto_align_axis(scene, room, np.array([0.0, 1.0, 0.0], np.float32))


def rotate_plane(plane, rot: np.ndarray, device="cuda"):
    """Rotate a free-standing plane about its boundary mean
    (ref Main.hs:1586-1593 rotatePlaneAround/rotatePlane)."""
    device = on_device(device)
    center = f32(plane.mean(), device)
    rot_t = f32(rot, device)
    eq = rotate_plane_eq_around(PlaneEq(f32(plane.normal, device), f32(plane.d, device)), center,
                                rot_t)
    bounds = plane.bounds
    if len(bounds):
        bounds = rotate_around(center, rot_t, f32(bounds, device)).cpu().numpy()
    return replace(plane, normal=eq.normal.cpu().numpy(), d=float(eq.d), bounds=bounds)


def rotate_room_to_match_walls(scene: Scene, plane_id1, plane_id2):
    """The reference's rotateSelectedPlanes 'r' key (ref Main.hs:1629-1654).

    Room branch: rotate the room containing plane 1 so that wall faces
    OPPOSITE wall plane 2 — the rotation takes plane 1's normal onto the
    FLIPPED plane-2 normal, so two walls that should touch end up
    antiparallel. Returns the rotated Room.

    Bare-plane branch (ref Main.hs:1645-1648): when plane 1 belongs to no
    room, rotate the plane itself onto plane 2's UNFLIPPED normal and ADD
    the result as a new free-standing plane with a fresh ID (the
    reference's addPlane); the original plane is kept, exactly as the
    reference did. Returns the new Plane."""
    device = on_device(scene.device)
    room = scene.find_room_containing_plane(plane_id1)
    p1 = scene.get_any_plane(plane_id1)
    p2 = scene.get_any_plane(plane_id2)
    if p1 is None or p2 is None:
        raise KeyError(f"planes {plane_id1},{plane_id2} not found")
    if room is None:
        rot = rotation_between_normals(f32(p1.normal, device), f32(p2.normal, device))
        new_plane = replace(rotate_plane(p1, rot.cpu().numpy(), device=device),
                            plane_id=scene.gen_id())
        scene.planes[new_plane.plane_id] = new_plane
        return new_plane
    target = flip_plane_eq(p2.eq(device))
    rot = rotation_between_normals(f32(p1.normal, device), target.normal).cpu().numpy()
    new_room = rotate_room(room, rot, device=device)
    scene.update_room(new_room)
    return new_room
