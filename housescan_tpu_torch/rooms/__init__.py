"""The room stage: load scanned rooms, find corners, fit cuboids, connect
walls across rooms, optimise the rooms' positions and export the placed
models. A port of ``housescan_tpu/rooms``; records stay host numpy, the
array math runs on ``Scene.device`` or the ``device`` argument (default
the card)."""

from housescan_tpu_torch.rooms.types import (
    NO_ID,
    Axis,
    Cloud,
    Plane,
    Room,
    Scene,
    WallRelation,
)
from housescan_tpu_torch.rooms.load import load_room, planes_from_dir
from housescan_tpu_torch.rooms.ops import (
    project_room,
    remove_ceiling,
    rotate_kinfu_room,
    rotate_room,
    rotate_room_around,
    translate_room,
)
from housescan_tpu_torch.rooms.corners import (
    accept_corner_suggestion,
    add_corner_from_planes,
    adopt_bbox_corners,
    suggest_corners,
)
from housescan_tpu_torch.rooms.cuboid import fit_cuboid_to_room, make_planes_from_cuboid
from housescan_tpu_torch.rooms.align import (
    auto_align_floor,
    room_auto_align_axis,
    rotate_room_to_match_walls,
)
from housescan_tpu_torch.rooms.walls import connect_walls, disconnect_walls, optimize_room_positions
from housescan_tpu_torch.rooms.export import (
    export_all_room_pcl_transforms,
    export_all_room_xf_files,
    export_room_full_res,
    room_projection_to_string,
)

__all__ = [
    "NO_ID",
    "Axis",
    "Cloud",
    "Plane",
    "Room",
    "Scene",
    "WallRelation",
    "load_room",
    "planes_from_dir",
    "project_room",
    "remove_ceiling",
    "rotate_kinfu_room",
    "rotate_room",
    "rotate_room_around",
    "translate_room",
    "add_corner_from_planes",
    "suggest_corners",
    "accept_corner_suggestion",
    "adopt_bbox_corners",
    "fit_cuboid_to_room",
    "make_planes_from_cuboid",
    "auto_align_floor",
    "room_auto_align_axis",
    "rotate_room_to_match_walls",
    "connect_walls",
    "disconnect_walls",
    "optimize_room_positions",
    "export_all_room_pcl_transforms",
    "export_all_room_xf_files",
    "export_room_full_res",
    "room_projection_to_string",
]
