"""Interactive-style scene manipulation ops.

Capability parity with the reference's move/duplicate/swap toolkit
(ref Main.hs:2007-2026 swapRoomPositions, :2209-2223 duplicate plane,
:2226-2259 moveDirection for walls with corner dragging, :2262-2268
moveAllRooms). These were key-bound in the GLUT viewer; here they are
plain functions the CLI / API exposes. A port of
``housescan_tpu/rooms/manip.py``, computing on ``scene.device``.
"""

from __future__ import annotations

from dataclasses import replace
from typing import Optional

import numpy as np

from housescan_tpu_torch.geometry.plane import PlaneEq, translate_plane_eq
from housescan_tpu_torch.geometry.transform import f32, on_device
from housescan_tpu_torch.rooms.ops import translate_room
from housescan_tpu_torch.rooms.types import ID, Plane, Room, Scene


def translate_plane(plane: Plane, offset: np.ndarray, *, device="cuda") -> Plane:
    """Translate one plane: equation + boundary (ref Main.hs:1691-1694)."""
    device = on_device(device)
    eq = translate_plane_eq(PlaneEq(f32(plane.normal, device), f32(plane.d, device)),
                            f32(offset, device))
    return replace(
        plane,
        normal=eq.normal.cpu().numpy(),
        d=float(eq.d),
        bounds=plane.bounds + np.asarray(offset, np.float32),
    )


def move_wall(
    scene: Scene, plane_id: ID, direction: np.ndarray, step: float = 0.01
) -> Optional[Room]:
    """Move a wall plane by step*direction, dragging room corners that lie
    on it (ref Main.hs:2231-2257).

    Corner dragging matches the reference's semantics: only when ALL of the
    plane's boundary corners are current room corners (i.e. the planes were
    built from the corners) are the corresponding corners moved with the
    wall. Returns the updated room (or None if the plane is free-standing).
    """
    plane = scene.get_any_plane(plane_id)
    if plane is None:
        raise KeyError(f"no plane with ID {plane_id}")
    offset = np.asarray(direction, np.float32) * step
    moved = translate_plane(plane, offset, device=scene.device)

    room = scene.find_room_containing_plane(plane_id)
    if room is None:
        scene.planes[plane_id] = moved
        return None

    old_corners = [tuple(np.round(c, 6)) for c in plane.bounds]
    room_corner_keys = {tuple(np.round(c, 6)) for _, c in room.corners}
    new_planes = [moved if p.plane_id == plane_id else p for p in room.planes]

    corners = room.corners
    if old_corners and all(k in room_corner_keys for k in old_corners):
        mapping = {
            k: moved.bounds[i] for i, k in enumerate(old_corners)
        }
        corners = [
            (cid, mapping.get(tuple(np.round(c, 6)), c)) for cid, c in room.corners
        ]
    new_room = replace(room, planes=new_planes, corners=corners)
    scene.update_room(new_room)
    return new_room


def duplicate_plane(scene: Scene, plane_id: ID) -> Plane:
    """Duplicate a wall with a fresh ID (ref Main.hs:2209-2223)."""
    plane = scene.get_any_plane(plane_id)
    if plane is None:
        raise KeyError(f"no plane with ID {plane_id}")
    dup = replace(plane, plane_id=scene.gen_id())
    room = scene.find_room_containing_plane(plane_id)
    if room is not None:
        scene.update_room(replace(room, planes=[dup] + room.planes))
    else:
        scene.planes[dup.plane_id] = dup
    return dup


def swap_room_positions(scene: Scene, room_id1: ID, room_id2: ID) -> None:
    """Swap two rooms' positions by translating each to the other's cloud
    mean (ref Main.hs:2007-2026)."""
    r1 = scene.rooms[room_id1]
    r2 = scene.rooms[room_id2]
    m1, m2 = r1.mean(), r2.mean()
    scene.update_room(translate_room(r1, m2 - m1, device=scene.device))
    scene.update_room(translate_room(scene.rooms[room_id2], m1 - m2, device=scene.device))


def move_all_rooms(scene: Scene, offset: np.ndarray) -> None:
    """(ref Main.hs:2262-2268.)"""
    for room in list(scene.rooms.values()):
        scene.update_room(translate_room(room, offset, device=scene.device))


def clear_rooms(scene: Scene) -> None:
    """(ref Main.hs:1978-1996.)"""
    scene.rooms.clear()
    scene.connected_walls.clear()


def delete_plane(scene: Scene, plane_id: ID) -> None:
    """Delete a plane from its room or the free-standing set
    (ref Main.hs:1467-1481)."""
    room = scene.find_room_containing_plane(plane_id)
    if room is not None:
        scene.update_room(
            replace(room, planes=[p for p in room.planes if p.plane_id != plane_id])
        )
    else:
        scene.planes.pop(plane_id, None)
