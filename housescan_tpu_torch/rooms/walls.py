"""Wall connections across rooms and global room-position optimization.

Capability parity with connectWalls / disconnectWalls /
optimizeRoomPositions (ref Main.hs:2039-2168): users connect pairs of
wall planes from different rooms ("opposite" with a wall thickness, or
"same" wall); the optimizer then solves, per world axis, a least-squares
positioning of room centers from the desired wall offsets, split into
connected components so no subproblem is underconstrained
(ref Main.hs:2126-2140). A port of ``housescan_tpu/rooms/walls.py``: the
least squares is the reference's host float64 solve; the rooms move on
``scene.device``.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from housescan_tpu_torch.rooms.ops import translate_room
from housescan_tpu_torch.rooms.types import ID, Axis, Plane, Room, Scene, WallRelation
from housescan_tpu_torch.solvers.translation_optimizer import lst_sq_distances
from housescan_tpu_torch.utils.graph import group_connected_components


def best_axis(normal: np.ndarray) -> Axis:
    """Dominant world axis of a normal (ref Main.hs:2053)."""
    return Axis(int(np.argmax(np.abs(normal))))


def connect_walls(
    scene: Scene, plane_id1: ID, plane_id2: ID, relation: WallRelation
) -> Optional[Axis]:
    """Connect two wall planes of different rooms (ref Main.hs:2039-2068).

    Returns the guessed axis, or None when the connection is rejected
    (planes not in two distinct rooms, axes disagree, or duplicate).
    """
    room1 = scene.find_room_containing_plane(plane_id1)
    room2 = scene.find_room_containing_plane(plane_id2)
    if room1 is None or room2 is None or room1.room_id == room2.room_id:
        return None  # "not walls of different rooms!" (ref Main.hs:2062-2063)

    p1 = room1.find_plane(plane_id1)
    p2 = room2.find_plane(plane_id2)
    a1, a2 = best_axis(p1.normal), best_axis(p2.normal)
    if a1 != a2:
        return None  # "Could not guess axis of wall connection" (ref Main.hs:2056)

    for _, _, pa, pb in scene.connected_walls:
        if (pa, pb) in ((plane_id1, plane_id2), (plane_id2, plane_id1)):
            return a1  # duplicate check (ref Main.hs:2059-2061)
    scene.connected_walls.insert(0, (a1, relation, plane_id1, plane_id2))
    return a1


def disconnect_walls(scene: Scene, plane_id1: ID, plane_id2: ID) -> None:
    """(ref Main.hs:2071-2086.)"""
    scene.connected_walls = [
        w
        for w in scene.connected_walls
        if (w[2], w[3]) not in ((plane_id1, plane_id2), (plane_id2, plane_id1))
    ]


def room_center_offset_from_walls(
    r1: Room, r2: Room, p1: Plane, p2: Plane, axis: Axis
) -> float:
    """Axis component of the center-to-center offset implied by two wall
    planes touching; assumes rooms are perfect cuboids
    (ref Main.hs:2187-2190)."""
    a = int(axis)
    return float(
        (p1.mean()[a] - r1.corner_mean()[a]) - (p2.mean()[a] - r2.corner_mean()[a])
    )


def optimize_room_positions(scene: Scene) -> List[Tuple[Axis, int, float]]:
    """Globally align room positions from wall connections
    (ref Main.hs:2089-2168).

    Per axis: build desired center-to-center offsets from each connected
    wall pair (geometric offset + sign * wall thickness for 'opposite', 0
    extra for 'same'), split into connected components, solve each with
    least squares, and translate rooms so the first room of each axis
    stays at its original position.

    Returns [(axis, component_size, rmse)] for observability (the
    reference printed these, ref Main.hs:2142, :2157).
    """
    walls_rooms = []
    for axis, relation, pid1, pid2 in scene.connected_walls:
        r1 = scene.find_room_containing_plane(pid1)
        r2 = scene.find_room_containing_plane(pid2)
        if r1 is None or r2 is None:
            raise ValueError(f"connected wall {pid1},{pid2} has no owning rooms")
        p1 = r1.find_plane(pid1)
        p2 = r2.find_plane(pid2)
        walls_rooms.append((p1, p2, r1, r2, axis, relation))

    for _, _, r1, r2, _, _ in walls_rooms:
        if not r1.corners or not r2.corners:
            # (ref Main.hs:2102-2103)
            raise ValueError("some room in position optimization has no corners!")

    results: List[Tuple[Axis, int, float]] = []
    for axis in (Axis.X, Axis.Y, Axis.Z):
        # Desired center-to-center offsets for this axis (ref Main.hs:2110-2118).
        desired: List[Tuple[Tuple[ID, ID], float]] = []
        axis_rooms = []
        for p1, p2, r1, r2, ax, relation in walls_rooms:
            if ax != axis:
                continue
            o = room_center_offset_from_walls(r1, r2, p1, p2, axis)
            wall_distance = relation.thickness if relation.kind == "opposite" else 0.0
            desired.append(
                ((r1.room_id, r2.room_id), o + float(np.sign(o)) * wall_distance)
            )
            axis_rooms.append(r1)

        if not desired:
            continue  # "Don't need to align along <axis>" (ref Main.hs:2122)
        first_room = axis_rooms[0]

        # Solve per connected component (ref Main.hs:2126-2150).
        for comp in group_connected_components(desired):
            solved = lst_sq_distances(dict(comp))
            if solved is None:
                # "WARNING: optimizeRoomPositions singularity error" (ref :2151)
                results.append((axis, len(comp), float("nan")))
                continue
            new_centers, rmse = solved
            results.append((axis, len(comp), rmse))

            # Anchor the first room at its original position (ref :2159-2162).
            first_center_comp = float(first_room.corner_mean()[int(axis)])
            for rid, new_center in new_centers.items():
                room = scene.rooms[rid]
                old_comp = float(room.corner_mean()[int(axis)])
                delta = (new_center + first_center_comp) - old_comp
                offset = np.zeros(3, np.float32)
                offset[int(axis)] = delta
                scene.update_room(translate_room(room, offset, device=scene.device))
    return results
