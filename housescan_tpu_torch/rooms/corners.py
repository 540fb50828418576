"""Room corner suggestion and selection.

Capability parity with the reference's corner workflow
(ref Main.hs:1484-1545): intersect all C(n,3) plane triples, keep
intersections within ``cutoff_factor x max-distance-from-room-mean``, and
auto-adopt when exactly 8 suggestions exist and the room has none yet.

The reference looped planeCorner over triples with per-call LAPACK solves;
here all triples are one batched device solve (plane_corners_batch), on
``scene.device``. A port of ``housescan_tpu/rooms/corners.py``; the plane
equations go to the device as float32 (``geometry.transform.f32``), as
``jnp.asarray`` makes them.
"""

from __future__ import annotations

from dataclasses import replace
from itertools import combinations
from typing import Optional, Tuple

import numpy as np
import torch

from housescan_tpu_torch.geometry.fitting import fit_plane, plane_corner, plane_corners_batch
from housescan_tpu_torch.geometry.plane import project_to_plane
from housescan_tpu_torch.geometry.transform import f32, on_device
from housescan_tpu_torch.rooms.ops import plane_arrays
from housescan_tpu_torch.rooms.types import ID, Plane, Room, Scene


def suggest_corners(
    scene: Scene, room: Room, cutoff_factor: float = 1.2
) -> Room:
    """Compute suggested corners for a room (ref Main.hs:1522-1538).

    Returns the updated room (also written into the scene). If the room
    has no corners yet and exactly 8 suggestions survive the cutoff, they
    are adopted directly as the room's corners.
    """
    planes = room.planes
    if len(planes) < 3:
        return room

    device = on_device(scene.device)
    triples = torch.tensor(list(combinations(range(len(planes)), 3)), device=device)
    points, valid = plane_corners_batch(plane_arrays(room, device), triples)
    points = points.cpu().numpy()
    valid = valid.cpu().numpy()

    room_mean = room.mean()
    max_mean_distance = float(
        np.max(np.linalg.norm(room.cloud.points - room_mean, axis=1))
    )
    cutoff = cutoff_factor * max_mean_distance  # (ref Main.hs:1527-1528)

    dist = np.linalg.norm(points - room_mean, axis=1)
    keep = valid & (dist <= cutoff)
    kept_points = [points[i] for i in range(len(points)) if keep[i]]
    suggested = scene.gen_ids(kept_points)

    if not room.corners and len(suggested) == 8:
        # "Only have 8 corners from the 6 planes - you have no choice"
        # (ref Main.hs:1532-1535)
        new_room = replace(room, corners=suggested, suggested_corners=[])
    else:
        new_room = replace(room, suggested_corners=suggested)
    scene.update_room(new_room)
    return new_room


def adopt_bbox_corners(scene: Scene, room: Room, max_snap: float = 0.1) -> Room:
    """Adopt the 8 corner suggestions nearest the cloud's bounding-box
    corners — the headless-orchestrator analog of the reference's
    accept-on-click (ref Main.hs:1541-1545, :1018-1047).

    suggest_corners auto-adopts only when EXACTLY 8 intersections
    survive the cutoff (ref Main.hs:1532-1535); a furnished room's
    RANSAC planes usually include furniture faces whose wall
    intersections add extra candidates, leaving the user to click the
    true corners. The true corners are the cloud's spatial extremes, so
    each bounding-box corner's nearest suggestion is adopted. Returns
    the room unchanged (suggestions intact, for interactive
    accept-corner) unless all 8 bbox corners snap to DISTINCT
    suggestions within ``max_snap`` meters."""
    if room.corners or len(room.suggested_corners) < 8:
        return room
    pts = np.asarray(room.cloud.points)
    lo, hi = pts.min(axis=0), pts.max(axis=0)
    chosen = []
    for sx in (0, 1):
        for sy in (0, 1):
            for sz in (0, 1):
                target = np.array(
                    [(lo[0], hi[0])[sx], (lo[1], hi[1])[sy], (lo[2], hi[2])[sz]]
                )
                sid, spt = min(
                    room.suggested_corners,
                    key=lambda s: float(np.linalg.norm(s[1] - target)),
                )
                if float(np.linalg.norm(spt - target)) > max_snap:
                    return room
                chosen.append(sid)
    if len(set(chosen)) != 8:
        return room
    for sid in chosen:
        room = accept_corner_suggestion(scene, room, sid)
    return room


def accept_corner_suggestion(scene: Scene, room: Room, sugg_id: ID) -> Room:
    """Move one suggested corner into the room's corners
    (ref Main.hs:1541-1545, :1484-1488)."""
    match = [s for s in room.suggested_corners if s[0] == sugg_id]
    if not match:
        raise KeyError(f"no corner suggestion with ID {sugg_id}")
    sugg = match[0]
    new_room = replace(
        room,
        corners=[sugg] + room.corners,
        suggested_corners=[s for s in room.suggested_corners if s[0] != sugg_id],
    )
    scene.update_room(new_room)
    return new_room


def add_corner_from_planes(
    scene: Scene, room: Room, plane_ids: Tuple[ID, ID, ID]
) -> Optional[Room]:
    """Corner from 3 selected planes of one room (ref Main.hs:1491-1519).

    Returns the updated room, or None if the planes don't intersect or the
    room already has 8 corners.
    """
    ps = [room.find_plane(pid) for pid in plane_ids]
    if any(p is None for p in ps):
        raise KeyError(f"planes {plane_ids} not all in room {room.room_id}")
    corner, ok = plane_corner(*(p.eq(scene.device) for p in ps))
    if not bool(ok):
        return None  # "Planes do not intersect!" (ref Main.hs:1498)
    if len(room.corners) >= 8:
        return None  # (ref Main.hs:1511)
    new_room = replace(
        room, corners=[(scene.gen_id(), corner.cpu().numpy())] + room.corners
    )
    scene.update_room(new_room)
    return new_room


def plane_from_points(
    scene: Scene, room: Room, points: np.ndarray, color=(1.0, 0.0, 0.0)
) -> Room:
    """Fit a plane to >= 3 picked points and add it to the room
    (ref Main.hs:1802-1811); bounds are the points projected onto the fit."""
    if len(points) < 3:
        raise ValueError(f"{len(points)} points given, need at least 3")
    pts = f32(points, scene.device)
    eq = fit_plane(pts)
    bounds = project_to_plane(eq, pts).cpu().numpy()
    plane = Plane(
        plane_id=scene.gen_id(),
        normal=eq.normal.cpu().numpy(),
        d=float(eq.d),
        color=color,
        bounds=bounds,
    )
    new_room = replace(room, planes=[plane] + room.planes)
    scene.update_room(new_room)
    return new_room
