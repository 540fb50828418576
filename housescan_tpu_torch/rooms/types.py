"""Domain model: Cloud, Plane, Room, Scene (a copy of
``housescan_tpu/rooms/types.py``).

``Cloud`` (ID, colour(s), points), ``Plane`` (ID, equation, colour,
boundary polygon), ``Room`` (ID, planes, cloud, corners, suggested
corners, cumulative transform, name), the wall-connection list and the ID
counter. The records are host state: mutable Python holding numpy
float32, as in the reference. ``Scene`` adds a ``device`` field (default
the card): the functions that take a scene compute on ``scene.device``
and bring the results back to numpy.

``random_color`` draws from an unseeded generator, as the reference's
does, so two loads of one directory give different colours: parity
checks must not compare colours.
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace
from enum import IntEnum
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

from housescan_tpu_torch.geometry.plane import PlaneEq
from housescan_tpu_torch.geometry.transform import on_device

ID = int
NO_ID: ID = 0xFFFFFFFF  # "no object" sentinel (ref Main.hs:348-349)
FIRST_ID: ID = 1  # (ref Main.hs:351-352)

Color = Tuple[float, float, float]


class Axis(IntEnum):
    """World axis (ref Main.hs:333-334). Y is up, matching the reference's
    OpenGL convention (removeCeiling cuts along Y, ref Main.hs:2652)."""

    X = 0
    Y = 1
    Z = 2

    def unit(self, dtype=np.float32) -> np.ndarray:
        v = np.zeros(3, dtype)
        v[int(self)] = 1.0
        return v


@dataclass(frozen=True)
class WallRelation:
    """Relation between two connected wall planes (ref Main.hs:339-342):
    ``opposite`` walls of two adjacent rooms separated by a thickness, or
    the ``same`` physical wall seen from the same side."""

    kind: str  # "opposite" | "same"
    thickness: float = 0.0  # meters; only meaningful for "opposite"

    @staticmethod
    def opposite(thickness: float) -> "WallRelation":
        return WallRelation("opposite", thickness)

    @staticmethod
    def same() -> "WallRelation":
        return WallRelation("same", 0.0)


@dataclass
class Cloud:
    """Point cloud with one color or per-point colors (ref Main.hs:112-121)."""

    cloud_id: ID
    points: np.ndarray  # (N, 3) float32
    one_color: Optional[Color] = (1.0, 0.0, 0.0)
    colors: Optional[np.ndarray] = None  # (N, 3) float32, exclusive with one_color

    def bump_ids(self, n: ID) -> "Cloud":
        return replace(self, cloud_id=self.cloud_id + n)

    def get_ids(self) -> List[ID]:
        return [self.cloud_id]


@dataclass
class Plane:
    """Wall/floor/ceiling plane: equation + boundary polygon
    (ref Main.hs:265-278)."""

    plane_id: ID
    normal: np.ndarray  # (3,) float32, unit, n . x = d
    d: float
    color: Color = (1.0, 0.0, 0.0)
    bounds: np.ndarray = field(default_factory=lambda: np.zeros((0, 3), np.float32))

    def eq(self, device="cuda") -> PlaneEq:
        """As a float32 PlaneEq on ``device``."""
        device = on_device(device)
        return PlaneEq(torch.as_tensor(self.normal, dtype=torch.float32, device=device),
                       torch.tensor(self.d, dtype=torch.float32, device=device))

    def mean(self) -> np.ndarray:
        """Centroid of the boundary polygon (ref Main.hs:1608-1609)."""
        return self.bounds.mean(axis=0)

    def bump_ids(self, n: ID) -> "Plane":
        return replace(self, plane_id=self.plane_id + n)

    def get_ids(self) -> List[ID]:
        return [self.plane_id]


@dataclass
class Room:
    """A scanned room (ref Main.hs:308-331)."""

    room_id: ID
    planes: List[Plane]
    cloud: Cloud
    corners: List[Tuple[ID, np.ndarray]] = field(default_factory=list)
    suggested_corners: List[Tuple[ID, np.ndarray]] = field(default_factory=list)
    # Cumulative transform vs. the as-loaded pose; 4x4 row-vector convention
    # (ref Main.hs:314 roomProj).
    proj: np.ndarray = field(default_factory=lambda: np.eye(4, dtype=np.float32))
    name: str = "ANON"

    def mean(self) -> np.ndarray:
        """Cloud centroid (ref Main.hs:1662-1663)."""
        return self.cloud.points.mean(axis=0)

    def corner_mean(self) -> np.ndarray:
        """Mean of the room's corner points (ref Main.hs:2183-2184)."""
        return np.stack([c for _, c in self.corners]).mean(axis=0)

    def find_plane(self, plane_id: ID) -> Optional[Plane]:
        for p in self.planes:
            if p.plane_id == plane_id:
                return p
        return None

    def bump_ids(self, n: ID) -> "Room":
        return replace(
            self,
            room_id=self.room_id + n,
            planes=[p.bump_ids(n) for p in self.planes],
            cloud=self.cloud.bump_ids(n),
            corners=[(i + n, c) for i, c in self.corners],
            suggested_corners=[(i + n, c) for i, c in self.suggested_corners],
        )

    def get_ids(self) -> List[ID]:
        ids = [self.room_id]
        for p in self.planes:
            ids.extend(p.get_ids())
        ids.extend(self.cloud.get_ids())
        ids.extend(i for i, _ in self.corners)
        ids.extend(i for i, _ in self.suggested_corners)
        return ids


# One wall connection: (axis, relation, plane_id_1, plane_id_2)
# (ref Main.hs:225 sConnectedWalls).
WallConnection = Tuple[Axis, WallRelation, ID, ID]


@dataclass
class Scene:
    """The live scene: rooms + wall connections + the ID counter.

    Merges the reference's persistent ``Save`` (ref Main.hs:252-255) with
    the transient room/wall/ID state (ref Main.hs:217-229) into one
    explicit object. Mutable on the host; never traced.
    """

    rooms: Dict[ID, Room] = field(default_factory=dict)
    connected_walls: List[WallConnection] = field(default_factory=list)
    next_id: ID = FIRST_ID
    # Free-standing planes not belonging to a room (ref Main.hs:221 sPlanes).
    planes: Dict[ID, Plane] = field(default_factory=dict)
    # Where the functions that take this scene compute.
    device: str = "cuda"

    def gen_id(self) -> ID:
        """Fresh unique object ID (ref Main.hs:355-357)."""
        i = self.next_id
        self.next_id = (self.next_id + 1) % NO_ID
        return i

    def gen_ids(self, items: Iterable) -> List[Tuple[ID, object]]:
        """Pair each item with a fresh ID (ref Main.hs:360-363)."""
        return [(self.gen_id(), x) for x in items]

    def add_room(self, room: Room) -> None:
        self.rooms[room.room_id] = room

    def update_room(self, room: Room) -> None:
        self.rooms[room.room_id] = room

    def find_room_containing_plane(self, plane_id: ID) -> Optional[Room]:
        """(ref Main.hs:1612-1613.)"""
        for room in self.rooms.values():
            if room.find_plane(plane_id) is not None:
                return room
        return None

    def get_any_plane(self, plane_id: ID) -> Optional[Plane]:
        """Look up a plane in rooms or free-standing (ref Main.hs:1458-1464)."""
        if plane_id in self.planes:
            return self.planes[plane_id]
        for room in self.rooms.values():
            p = room.find_plane(plane_id)
            if p is not None:
                return p
        return None

    def all_ids(self) -> List[ID]:
        ids: List[ID] = []
        for room in self.rooms.values():
            ids.extend(room.get_ids())
        ids.extend(self.planes.keys())
        return ids


def random_color(rng: Optional[np.random.Generator] = None) -> Color:
    """Random saturated color for plane display (ref Main.hs getRandomColor
    usage at :1401)."""
    rng = rng or np.random.default_rng()
    c = rng.uniform(0.2, 1.0, size=3)
    return (float(c[0]), float(c[1]), float(c[2]))
