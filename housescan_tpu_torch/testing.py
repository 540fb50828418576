"""Synthetic room directories for tests, demos and benchmarks: a copy of
``housescan_tpu/testing.py``.

Synthetic cuboid rooms, written on demand in the on-disk layout that
``rooms.load_room`` reads (cloud_downsampled.pcd, planes.txt,
cloud_plane_hull<k>.pcd, cloud_bin.pcd), so every room-stage step is
testable without recorded data. Host numpy; the same arguments write the
same files as the reference's copy.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional, Sequence, Tuple, Union

import numpy as np

from housescan_tpu_torch.geometry.plane import PlaneEq
from housescan_tpu_torch.io.pcd import save_pcd
from housescan_tpu_torch.io.planes_txt import save_planes_txt


def cuboid_room_points(
    dims: Sequence[float],
    n_per_face: int = 400,
    noise: float = 0.0,
    rng: Optional[np.random.Generator] = None,
    rot: Optional[np.ndarray] = None,
    offset: Optional[np.ndarray] = None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, list]:
    """Sample points on the 6 faces of a cuboid room centered at the
    origin, optionally rotated (row-vector matrix) and translated.

    Returns (points (6n, 3), inward face normals (6, 3), face d (6,),
    per-face hull corners in perimeter order)."""
    rng = rng or np.random.default_rng(0)
    a, b, c = (float(d) for d in dims)
    half = np.array([a, b, c]) / 2

    points, normals, ds, hulls = [], [], [], []
    for axis in range(3):
        for sign in (+1.0, -1.0):
            u, v = [i for i in range(3) if i != axis]
            uv = rng.uniform(-1, 1, size=(n_per_face, 2))
            face_pts = np.zeros((n_per_face, 3))
            face_pts[:, axis] = sign * half[axis]
            face_pts[:, u] = uv[:, 0] * half[u]
            face_pts[:, v] = uv[:, 1] * half[v]
            if noise > 0:
                face_pts += rng.normal(scale=noise, size=face_pts.shape)
            points.append(face_pts)

            # inward normal -sign along the axis; n . x = d at x_axis = sign * half
            n = np.zeros(3)
            n[axis] = -sign
            normals.append(n)
            ds.append(-half[axis])

            # the 4 face corners in perimeter order (not a self-crossing bowtie)
            corners = []
            for su, sv in ((-1, -1), (-1, 1), (1, 1), (1, -1)):
                p = np.zeros(3)
                p[axis] = sign * half[axis]
                p[u] = su * half[u]
                p[v] = sv * half[v]
                corners.append(p)
            hulls.append(np.stack(corners))

    points = np.concatenate(points).astype(np.float32)
    normals = np.stack(normals).astype(np.float32)
    ds = np.asarray(ds, np.float32)

    if rot is not None:
        rot = np.asarray(rot, np.float32)
        points = points @ rot
        hulls = [h.astype(np.float32) @ rot for h in hulls]
        new_normals = normals @ rot
        # d' from a point of each plane: n d, rotated
        ds = np.einsum("kj,kj->k", normals * ds[:, None] @ rot, new_normals)
        normals = new_normals
    else:
        hulls = [h.astype(np.float32) for h in hulls]
    if offset is not None:
        offset = np.asarray(offset, np.float32)
        points = points + offset
        hulls = [h + offset for h in hulls]
        ds = ds + normals @ offset

    return points, normals, ds, hulls


def make_synthetic_room_dir(
    room_dir: Union[str, Path],
    dims: Sequence[float] = (4.0, 2.5, 5.0),
    n_per_face: int = 400,
    noise: float = 0.0,
    seed: int = 0,
    rot: Optional[np.ndarray] = None,
    offset: Optional[np.ndarray] = None,
    full_res_factor: int = 4,
) -> Path:
    """Write a reference-layout room directory for a synthetic cuboid
    room. planes.txt gets randomly oriented normals (half flipped, as
    PCL's detector gives no orientation), which ``load_room`` turns
    inward."""
    room_dir = Path(room_dir)
    room_dir.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)

    points, normals, ds, hulls = cuboid_room_points(
        dims, n_per_face=n_per_face, noise=noise, rng=rng, rot=rot, offset=offset
    )
    save_pcd(room_dir / "cloud_downsampled.pcd", points)
    full, _, _, _ = cuboid_room_points(
        dims, n_per_face=n_per_face * full_res_factor, noise=noise, rng=rng, rot=rot,
        offset=offset,
    )
    save_pcd(room_dir / "cloud_bin.pcd", full)

    flips = np.where(rng.uniform(size=len(ds)) < 0.5, -1.0, 1.0).astype(np.float32)
    # PlaneEq of host arrays: the writer reads them through io.host
    save_planes_txt(room_dir / "planes.txt", PlaneEq(normals * flips[:, None], ds * flips))
    for k, hull in enumerate(hulls):
        save_pcd(room_dir / f"cloud_plane_hull{k}.pcd", hull)
    return room_dir

