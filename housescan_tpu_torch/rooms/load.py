"""Room loading from a scan directory (a copy of
``housescan_tpu/rooms/load.py``; host numpy, no device work).

Capability parity with the reference's loadRoom / planesFromDir
(ref Main.hs:1738-1762, :1392-1404): a room directory contains

    cloud_downsampled.pcd     the interaction-resolution cloud
    planes.txt                K detected planes (PCL convention)
    cloud_plane_hull<k>.pcd   boundary polygon of plane k
    cloud_bin.pcd / .ply      (optional) full-res cloud for final export

On load, every plane normal is flipped to face the room-cloud centroid
(inward, ref Main.hs:1744-1751).
"""

from __future__ import annotations

from dataclasses import replace
from pathlib import Path
from typing import List, Optional, Union

import numpy as np

from housescan_tpu_torch.io.pcd import load_pcd
from housescan_tpu_torch.io.planes_txt import load_planes_txt
from housescan_tpu_torch.rooms.types import Cloud, Plane, Room, Scene, random_color


def cloud_from_file(scene: Scene, path: Union[str, Path]) -> Cloud:
    """Load a .pcd as a Cloud, using per-point colors when present
    (ref Main.hs:1334-1345)."""
    pc = load_pcd(path)
    if len(pc) == 0:
        raise ValueError(f"File {path} contains no points!")
    if pc.colors is not None:
        return Cloud(scene.gen_id(), pc.points, one_color=None, colors=pc.colors)
    return Cloud(scene.gen_id(), pc.points, one_color=(1.0, 0.0, 0.0))


def planes_from_dir(
    scene: Scene, room_dir: Union[str, Path], rng: Optional[np.random.Generator] = None
) -> List[Plane]:
    """planes.txt + per-plane hull clouds -> Plane list (ref Main.hs:1392-1404)."""
    room_dir = Path(room_dir)
    eqs = load_planes_txt(room_dir / "planes.txt")
    normals = eqs.normal.numpy()
    ds = eqs.d.numpy()
    planes = []
    for k in range(len(ds)):
        hull_file = room_dir / f"cloud_plane_hull{k}.pcd"
        bounds = load_pcd(hull_file).points
        planes.append(
            Plane(
                plane_id=scene.gen_id(),
                normal=normals[k],
                d=float(ds[k]),
                color=random_color(rng),
                bounds=bounds,
            )
        )
    return planes


def make_inward_facing(plane: Plane, room_center: np.ndarray) -> Plane:
    """Flip the plane so its normal points toward the room centroid
    (ref Main.hs:1744-1751)."""
    inward = room_center - plane.mean()
    if float(np.dot(inward, plane.normal)) > 0:
        return plane
    return replace(plane, normal=-plane.normal, d=-plane.d)


def load_room(
    scene: Scene, room_dir: Union[str, Path], rng: Optional[np.random.Generator] = None
) -> Room:
    """Load a room directory into the scene with inward-facing planes and
    identity proj (ref Main.hs:1738-1762)."""
    room_dir = Path(room_dir)
    cloud = cloud_from_file(scene, room_dir / "cloud_downsampled.pcd")
    room_center = cloud.points.mean(axis=0)
    planes = [make_inward_facing(p, room_center) for p in planes_from_dir(scene, room_dir, rng)]
    room = Room(
        room_id=scene.gen_id(),
        planes=planes,
        cloud=cloud,
        name=str(room_dir),
    )
    scene.update_room(room)
    return room
