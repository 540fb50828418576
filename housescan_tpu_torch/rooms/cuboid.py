"""Cuboid fitting at the room level.

Capability parity with fitCuboidToRoom / makePlanesFromCuboid
(ref Main.hs:1814-1885): fit an oriented cuboid to the room's 8 corners,
then replace the room's corners and planes with the cuboid's own —
reusing the existing corner IDs and purging wall connections that
referenced the replaced planes. A port of ``housescan_tpu/rooms/cuboid.py``:
the fit and the face planes are computed on ``scene.device``, from float32
corners (``geometry.transform.f32``, as ``jnp.asarray`` makes them).
"""

from __future__ import annotations

import math
from dataclasses import replace
from typing import List, Optional, Tuple

import numpy as np
import torch

from housescan_tpu_torch.geometry.plane import (
    mk_plane_eq,
    rotate_plane_eq_around,
    signed_distance_to_plane,
    translate_plane_eq,
)
from housescan_tpu_torch.geometry.transform import f32, on_device, quat_rot_mat
from housescan_tpu_torch.rooms.types import Plane, Room, Scene, random_color
from housescan_tpu_torch.solvers.cuboid_fit import cuboid_from_params, fit_cuboid_from_center_first


def make_planes_from_cuboid(
    scene: Scene,
    cuboid_points: np.ndarray,
    center: np.ndarray,
    dims: np.ndarray,
    quat: np.ndarray,
    membership_tol: float = 1e-4,
    rng=None,
) -> List[Plane]:
    """Build the 6 face planes of a fitted cuboid (ref Main.hs:1852-1885).

    Planes are constructed axis-aligned at the origin, then rotated by the
    fit quaternion and translated to the fit center. Each face's boundary
    polygon is the 4 cuboid corners on that face, reordered into a
    non-self-intersecting quad (ref Main.hs:1876-1878). Normals face
    inward (the reference's +a/2 planes with normals pointing at the
    center).
    """
    device = on_device(scene.device)
    rot = quat_rot_mat(f32(quat, device))
    a, b, c = float(dims[0]), float(dims[1]), float(dims[2])
    # INWARD-facing normals: the +a/2 face gets normal -x, etc. (The
    # reference built these with outward normals, ref Main.hs:1855-1860,
    # inconsistent with its own loadRoom inward normalization at
    # Main.hs:1744-1751; we keep inward as the package-wide invariant so
    # wall selection by normal sign is reliable.)
    normals = np.array([[-1.0, 0, 0], [1.0, 0, 0], [0, -1.0, 0], [0, 1.0, 0], [0, 0, -1.0],
                        [0, 0, 1.0]], np.float32)
    ds = np.array([-a / 2, -a / 2, -b / 2, -b / 2, -c / 2, -c / 2], np.float32)

    # Tolerance scale: face membership is checked in absolute meters
    # (ref Main.hs:1882 '< 1e-4'); scale with cuboid size for robustness
    # on f32 fits of large rooms.
    tol = max(membership_tol, 1e-5 * max(a, b, c, 1.0))

    # the six faces at once: made at the origin, rotated, moved to the center
    eq0 = mk_plane_eq(f32(normals, device), f32(ds, device))
    eq = translate_plane_eq(rotate_plane_eq_around(eq0, torch.zeros(3, device=device), rot),
                            f32(center, device))
    dists = signed_distance_to_plane(
        eq._replace(normal=eq.normal[:, None], d=eq.d[:, None]), f32(cuboid_points, device)[None]
    ).abs().cpu().numpy()
    face_normals, face_ds = eq.normal.cpu().numpy(), eq.d.cpu().numpy()

    planes: List[Plane] = []
    for k in range(6):
        face = cuboid_points[dists[k] < max(tol, dists[k].min() * 4 + 1e-7)]
        if len(face) != 4:
            # fall back: take the 4 closest corners (degenerate thin cuboids)
            face = cuboid_points[np.argsort(dists[k])[:4]]
        planes.append(
            Plane(
                plane_id=scene.gen_id(),
                normal=face_normals[k],
                d=float(face_ds[k]),
                color=random_color(rng),
                bounds=_reorder_polygon(face),
            )
        )
    return planes


def _reorder_polygon(corners: np.ndarray) -> np.ndarray:
    """Order 4 coplanar points into a quad perimeter: nearest two to c1
    are its edge-neighbors, the farthest is opposite
    (ref Main.hs:1876-1878: [c1, c2, c4, c3] after sorting by distance)."""
    c1 = corners[0]
    rest = corners[1:]
    order = np.argsort(np.linalg.norm(rest - c1, axis=1))
    c2, c3, c4 = rest[order[0]], rest[order[1]], rest[order[2]]
    return np.stack([c1, c2, c4, c3])


def fit_cuboid_to_room(
    scene: Scene, room: Room, tol: float = 1e-8, max_iter: int = 2000
) -> Optional[Tuple[Room, float, int]]:
    """Fit a cuboid to the room corners and swap in its geometry
    (ref Main.hs:1814-1849).

    Returns (new_room, rmse, steps) or None if the room lacks 8 corners.
    RMSE is sqrt of the fit objective, matching the reference's printout
    (ref Main.hs:1827).
    """
    if len(room.corners) < 8:
        return None  # "not enough room corners; need 8" (ref Main.hs:1820)

    points = np.stack([c for _, c in room.corners[:8]])
    fit = fit_cuboid_from_center_first(points, tol=tol, max_iter=max_iter, device=scene.device)
    new_room = apply_cuboid_fit(scene, room, fit.params)
    return new_room, float(math.sqrt(float(fit.error))), int(fit.n_steps)


def apply_cuboid_fit(scene: Scene, room: Room, fit_params) -> Room:
    """Swap a fitted cuboid's geometry into the room (the mutation half
    of fit_cuboid_to_room, ref Main.hs:1830-1849), also for params that
    arrive as one row of ``fit_cuboid_batch``."""
    params = torch.as_tensor(fit_params).cpu().numpy().astype(np.float32)
    cuboid_points = cuboid_from_params(f32(params, scene.device)).cpu().numpy()

    old_plane_ids = {p.plane_id for p in room.planes}
    cuboid_planes = make_planes_from_cuboid(
        scene, cuboid_points, params[0:3], params[3:6], params[6:10]
    )

    # Re-use corner IDs (ref Main.hs:1839).
    new_corners = [
        (cid, cuboid_points[k]) for k, (cid, _) in enumerate(room.corners[:8])
    ]
    new_room = replace(room, corners=new_corners, planes=cuboid_planes)
    scene.update_room(new_room)

    # Remove stale wall connections referencing replaced planes
    # (ref Main.hs:1846-1849).
    scene.connected_walls = [
        w
        for w in scene.connected_walls
        if w[2] not in old_plane_ids and w[3] not in old_plane_ids
    ]
    return new_room
