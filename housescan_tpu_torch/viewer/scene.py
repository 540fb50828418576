"""Headless scene queries: what lies under a pixel (a copy of
``housescan_tpu/viewer/scene.py``, numpy on the host).

Picking casts the pixel ray and tests it against the scene analytically:
plane polygons (ray/plane intersection, then point-in-polygon in the
plane's basis), corners and suggested corners (spheres of a pick radius)
and clouds (the nearest point within an angular pick radius).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import numpy as np

from housescan_tpu_torch.kinfu.camera import Intrinsics
from housescan_tpu_torch.rooms.types import ID, Scene


@dataclass
class PickResult:
    kind: str  # "plane" | "corner" | "suggested_corner" | "cloud" | "none"
    object_id: Optional[ID]
    room_id: Optional[ID]
    t: float  # ray depth of the hit
    point: Optional[np.ndarray] = None


def _pixel_ray(pose: np.ndarray, intr: Intrinsics, u: float, v: float):
    d_cam = np.array([(u - intr.cx) / intr.fx, (v - intr.cy) / intr.fy, 1.0])
    rot = pose[:3, :3]
    origin = pose[3, :3]
    return origin, d_cam @ rot  # t parameter equals projective depth


def _point_in_polygon(point: np.ndarray, polygon: np.ndarray, normal: np.ndarray) -> bool:
    """2D point-in-polygon in the plane basis (winding-agnostic)."""
    if len(polygon) < 3:
        return False
    helper = np.array([1.0, 0, 0]) if abs(normal[0]) < 0.9 else np.array([0, 1.0, 0])
    e1 = np.cross(normal, helper)
    e1 /= np.linalg.norm(e1)
    e2 = np.cross(normal, e1)
    p2 = np.array([point @ e1, point @ e2])
    poly2 = np.stack([polygon @ e1, polygon @ e2], axis=1)
    inside = False
    j = len(poly2) - 1
    for i in range(len(poly2)):
        a, b = poly2[i], poly2[j]
        if (a[1] > p2[1]) != (b[1] > p2[1]):
            x = (b[0] - a[0]) * (p2[1] - a[1]) / (b[1] - a[1]) + a[0]
            if p2[0] < x:
                inside = not inside
        j = i
    return inside


def pick(
    scene: Scene,
    pose: np.ndarray,
    intr: Intrinsics,
    u: float,
    v: float,
    corner_radius: float = 0.05,
    cloud_pick_pixels: float = 3.0,
) -> PickResult:
    """What is under pixel (u, v) from camera ``pose``?

    Priority on ties (smallest t wins overall; corners win over their own
    planes within the pick radius, like the reference's draw order).
    """
    origin, direction = _pixel_ray(np.asarray(pose, np.float64), intr, u, v)
    best = PickResult("none", None, None, float("inf"))

    for room in scene.rooms.values():
        # corner spheres
        for kind, pairs in (
            ("corner", room.corners),
            ("suggested_corner", room.suggested_corners),
        ):
            for cid, c in pairs:
                rel = np.asarray(c, np.float64) - origin
                t = rel @ direction / (direction @ direction)
                if t <= 0:
                    continue
                dist = np.linalg.norm(rel - t * direction)
                if dist < corner_radius:
                    # Ray-sphere SURFACE depth: the drawn pick sphere
                    # sits in front of coincident cloud/plane geometry
                    # (the reference's sphere draw order, Main.hs:672),
                    # so a corner must win against surface points at the
                    # same world position.
                    t_hit = t - float(np.sqrt(corner_radius**2 - dist**2))
                    if 0 < t_hit < best.t:
                        best = PickResult(
                            kind, cid, room.room_id, float(t_hit), np.asarray(c)
                        )

        # plane polygons
        for p in room.planes:
            denom = float(np.asarray(p.normal, np.float64) @ direction)
            if abs(denom) < 1e-12:
                continue
            t = (p.d - np.asarray(p.normal, np.float64) @ origin) / denom
            if t <= 0 or t >= best.t:
                continue
            hit = origin + t * direction
            if _point_in_polygon(hit, np.asarray(p.bounds, np.float64), np.asarray(p.normal, np.float64)):
                best = PickResult("plane", p.plane_id, room.room_id, float(t), hit)

        # cloud points (angular pick radius)
        pts = np.asarray(room.cloud.points, np.float64)
        if len(pts):
            rel = pts - origin
            tproj = rel @ direction / (direction @ direction)
            ok = tproj > 0
            if ok.any():
                perp = rel - tproj[:, None] * direction
                perp_px = (
                    np.linalg.norm(perp, axis=1)
                    / np.maximum(tproj, 1e-9)
                    * intr.fx
                )
                cand = ok & (perp_px < cloud_pick_pixels) & (tproj < best.t)
                if cand.any():
                    k = int(np.argmin(np.where(cand, tproj, np.inf)))
                    best = PickResult(
                        "cloud", room.cloud.cloud_id, room.room_id, float(tproj[k]), pts[k]
                    )

    return best


def visible_objects(
    scene: Scene, pose: np.ndarray, intr: Intrinsics, step: int = 16
) -> List[PickResult]:
    """Coarse visibility sweep: pick on a pixel grid (the headless
    analogue of hovering the whole window, ref Main.hs:936-939)."""
    out = []
    seen = set()
    for v in range(step // 2, intr.height, step):
        for u in range(step // 2, intr.width, step):
            r = pick(scene, pose, intr, u, v)
            if r.kind != "none" and (r.kind, r.object_id) not in seen:
                seen.add((r.kind, r.object_id))
                out.append(r)
    return out
