"""Transform export and full-resolution model output.

Capability parity with the reference's export layer (ref Main.hs:2193-2325)
— each room's cumulative 4x4 transform, transposed to the
left-multiplicative convention, as:

  * a CSV string for ``pcl_transform_point_cloud`` command lines
    (ref Main.hs:2271-2284, :2305-2313)
  * ``.xf`` files for ``plyxform`` (ref Main.hs:2287-2302, :2316-2325)

— plus what the reference could NOT do in-process: actually applying the
transform to the full-resolution cloud/mesh on device and writing the
placed .pcd/.ply (the reference printed shell commands for external PCL
tools; SURVEY.md section 2b). A port of ``housescan_tpu/rooms/export.py``:
the placed points are computed on ``device`` (default the card) from
float32 inputs, since a .pcd may hold float64 fields and ``jnp.asarray``
would make them float32. As in the reference, per-point normals are
written as they were loaded, not rotated.
"""

from __future__ import annotations

from pathlib import Path
from typing import List, Optional, Union

import numpy as np

from housescan_tpu_torch.geometry.transform import apply_proj4, f32, on_device
from housescan_tpu_torch.io.pcd import PointCloud, load_pcd, save_pcd
from housescan_tpu_torch.io.ply import Mesh, load_ply, save_ply
from housescan_tpu_torch.io.xf import save_xf
from housescan_tpu_torch.rooms.types import Room, Scene


def room_projection_to_string(room: Room) -> str:
    """CSV of the 16 entries of the LEFT-multiplicative transform
    (ref Main.hs:2271-2284)."""
    m = np.asarray(room.proj, np.float64).T
    return ",".join(repr(float(v)) for v in m.flatten())


def room_projection_to_xf_format(room: Room) -> str:
    """The .xf text form (ref Main.hs:2289-2302)."""
    m = np.asarray(room.proj, np.float64).T
    return "\n".join(" ".join(repr(float(v)) for v in row) for row in m) + "\n"


def export_all_room_pcl_transforms(scene: Scene) -> List[str]:
    """pcl_transform_point_cloud command lines, one per room
    (ref Main.hs:2305-2313). Kept for drop-in compatibility with the
    reference's external workflow."""
    lines = []
    for room in scene.rooms.values():
        name = Path(room.name)
        out_name = f"{name.parent.parent.name if len(name.parts) > 2 else name.name}-placed.pcd"
        lines.append(
            f"pcl_transform_point_cloud {room.name} {out_name}"
            f" -matrix {room_projection_to_string(room)}"
        )
    return lines


def export_all_room_xf_files(scene: Scene, out_dir: Union[str, Path] = "xf") -> List[Path]:
    """Write one .xf per room into ``out_dir`` (ref Main.hs:2316-2325)."""
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    written = []
    for room in scene.rooms.values():
        stem = Path(room.name).name or f"room{room.room_id}"
        path = out_dir / f"{stem}.xf"
        save_xf(path, room.proj)
        written.append(path)
    return written


def _transform_points(points: np.ndarray, proj, device) -> np.ndarray:
    return apply_proj4(f32(proj, device), f32(points, device)).cpu().numpy()


def export_room_full_res(
    room: Room,
    out_path: Union[str, Path],
    full_res_path: Optional[Union[str, Path]] = None,
    device="cuda",
) -> Path:
    """Apply the room's cumulative transform to its full-resolution model
    and write the placed result.

    This replaces the reference's external pcl_transform_point_cloud /
    plyxform steps (ref Main.hs:2305-2325) with a single on-device matmul.
    ``full_res_path`` defaults to ``<room dir>/cloud_bin.pcd``
    (ref Main.hs:2437); .ply inputs/outputs are handled too.
    """
    out_path = Path(out_path)
    if full_res_path is None:
        full_res_path = Path(room.name) / "cloud_bin.pcd"
    full_res_path = Path(full_res_path)

    device = on_device(device)
    if full_res_path.suffix == ".ply":
        mesh = load_ply(full_res_path)
        placed = _transform_points(mesh.vertices, room.proj, device)
        out_mesh = Mesh(placed, faces=mesh.faces, colors=mesh.colors, normals=mesh.normals)
        if out_path.suffix == ".pcd":
            save_pcd(out_path, PointCloud(placed, colors=mesh.colors))
        else:
            save_ply(out_path, out_mesh)
    else:
        pc = load_pcd(full_res_path)
        placed = _transform_points(pc.points, room.proj, device)
        out_pc = PointCloud(placed, colors=pc.colors, normals=pc.normals)
        if out_path.suffix == ".ply":
            save_ply(out_path, Mesh(placed, colors=pc.colors))
        else:
            save_pcd(out_path, out_pc)
    return out_path
