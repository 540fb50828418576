"""Versioned scene checkpoints with schema migrations and ID rebasing.

A copy of ``housescan_tpu/io/checkpoint.py``; the files are the same
format both ways. A checkpoint is a zip holding ``manifest.json`` (the
schema version, its fingerprint and the scene's structure) and one
``.npy`` per array. ``MIGRATIONS`` upgrades an older manifest one
version at a time (v1: rooms only; v2: + connected walls; v3: + wall
thickness and settings; v4: + free-standing planes).
``load_scene(..., into=scene)`` rebases every loaded ID above the live
``next_id`` and merges.

``schema_fingerprint`` hashes the field names and annotation strings of
``Cloud``, ``Plane``, ``Room`` and ``WallRelation``; the port keeps those
annotations letter for letter, so both packages compute one fingerprint.
The port's ``Scene.device`` (where the room stage computes) is not
written: ``load_scene`` takes it as an argument.
"""

from __future__ import annotations

import dataclasses
import hashlib
import io as _io
import json
import zipfile
from pathlib import Path
from typing import Callable, Dict, Optional, Union

import numpy as np

from housescan_tpu_torch.rooms.types import (
    Axis,
    Cloud,
    Plane,
    Room,
    Scene,
    WallRelation,
)

CURRENT_VERSION = 4
DEFAULT_PATH = "save.housescan"  # (ref Main.hs:1920 'save.safecopy')


def schema_fingerprint() -> str:
    """Structural hash of the persisted dataclasses: field names + type
    names, order-sensitive. Renaming/adding/removing a field changes it
    (ref Main.hs:1207-1238 — refuse unsafe state restore)."""
    parts = []
    for cls in (Cloud, Plane, Room, WallRelation):
        for f in dataclasses.fields(cls):
            parts.append(f"{cls.__name__}.{f.name}:{f.type}")
    return hashlib.sha256("|".join(parts).encode()).hexdigest()[:16]


def _room_manifest(room: Room, arrays: Dict[str, np.ndarray], key: str) -> dict:
    arrays[f"{key}/cloud_points"] = room.cloud.points
    if room.cloud.colors is not None:
        arrays[f"{key}/cloud_colors"] = room.cloud.colors
    arrays[f"{key}/proj"] = np.asarray(room.proj, np.float32)
    planes = []
    for pi, p in enumerate(room.planes):
        arrays[f"{key}/plane{pi}/bounds"] = p.bounds
        planes.append(
            {
                "id": int(p.plane_id),
                "normal": [float(x) for x in p.normal],
                "d": float(p.d),
                "color": list(p.color),
            }
        )
    corners = [[int(i), [float(x) for x in c]] for i, c in room.corners]
    suggested = [[int(i), [float(x) for x in c]] for i, c in room.suggested_corners]
    return {
        "id": int(room.room_id),
        "cloud_id": int(room.cloud.cloud_id),
        "cloud_one_color": list(room.cloud.one_color) if room.cloud.one_color else None,
        "has_colors": room.cloud.colors is not None,
        "planes": planes,
        "corners": corners,
        "suggested_corners": suggested,
        "name": room.name,
    }


def save_scene(scene: Scene, path: Union[str, Path] = DEFAULT_PATH) -> Path:
    """Write the scene at the CURRENT schema version (ref Main.hs:1919-1932)."""
    arrays: Dict[str, np.ndarray] = {}
    manifest = {
        "schema_version": CURRENT_VERSION,
        "schema_fingerprint": schema_fingerprint(),
        "next_id": int(scene.next_id),
        "rooms": {
            str(rid): _room_manifest(room, arrays, f"room{rid}")
            for rid, room in scene.rooms.items()
        },
        "connected_walls": [
            [int(axis), rel.kind, float(rel.thickness), int(p1), int(p2)]
            for axis, rel, p1, p2 in scene.connected_walls
        ],
        "settings": {},
        # v4: free-standing planes. The reference kept sPlanes transient
        # (Main.hs:221 is not in Save, :252-255) — acceptable in a live
        # GLUT session, but this CLI is one process per subcommand, so
        # planes added by the bare-plane 'rotate' branch must survive.
        "free_planes": [
            {
                "id": int(p.plane_id),
                "normal": [float(x) for x in p.normal],
                "d": float(p.d),
                "color": list(p.color),
            }
            for p in scene.planes.values()
        ],
    }
    for p in scene.planes.values():
        arrays[f"free_plane{p.plane_id}/bounds"] = p.bounds

    path = Path(path)
    with zipfile.ZipFile(path, "w", zipfile.ZIP_DEFLATED) as zf:
        zf.writestr("manifest.json", json.dumps(manifest))
        for name, arr in arrays.items():
            buf = _io.BytesIO()
            np.save(buf, np.ascontiguousarray(arr))
            zf.writestr(name + ".npy", buf.getvalue())
    return path


def save_scene_async(scene: Scene, path: Union[str, Path] = DEFAULT_PATH):
    """Background checkpoint write (the host-async analog of the
    reference's forkIO usage, SURVEY.md section 2c): snapshots the scene
    SYNCHRONOUSLY (cheap: references numpy arrays, which are never
    mutated in place by the pipeline — ops replace them) and writes the
    zip on a worker thread. Returns the Thread; join() it to guarantee
    durability."""
    import threading

    snapshot = Scene(
        rooms=dict(scene.rooms),
        connected_walls=list(scene.connected_walls),
        next_id=scene.next_id,
        planes=dict(scene.planes),
        device=scene.device,
    )
    t = threading.Thread(target=save_scene, args=(snapshot, path), daemon=True)
    t.start()
    return t


# --- migrations -----------------------------------------------------------

def _migrate_v1_to_v2(manifest: dict) -> dict:
    """v1 was rooms-only (the reference's legacy Save_v1, ref Main.hs:1954)."""
    manifest = dict(manifest)
    manifest.setdefault("connected_walls", [])
    manifest["schema_version"] = 2
    return manifest


def _migrate_v2_to_v3(manifest: dict) -> dict:
    """v3 added a settings dict; wall relations gained an explicit
    thickness (older saves carry the reference's 10cm global default,
    ref Main.hs:2714)."""
    manifest = dict(manifest)
    walls = []
    for w in manifest.get("connected_walls", []):
        if len(w) == 4:  # v2: (axis, kind, p1, p2) — no thickness
            axis, kind, p1, p2 = w
            walls.append([axis, kind, 0.1, p1, p2])
        else:
            walls.append(w)
    manifest["connected_walls"] = walls
    manifest.setdefault("settings", {})
    manifest["schema_version"] = 3
    return manifest


def _migrate_v3_to_v4(manifest: dict) -> dict:
    """v4 added free-standing planes (empty in any older save — the
    reference never persisted them either, Main.hs:252-255)."""
    manifest = dict(manifest)
    manifest.setdefault("free_planes", [])
    manifest["schema_version"] = 4
    return manifest


MIGRATIONS: Dict[int, Callable[[dict], dict]] = {
    1: _migrate_v1_to_v2,
    2: _migrate_v2_to_v3,
    3: _migrate_v3_to_v4,
}


def _upgrade(manifest: dict) -> dict:
    version = manifest.get("schema_version", 1)
    if version > CURRENT_VERSION:
        raise ValueError(
            f"checkpoint schema v{version} is newer than supported v{CURRENT_VERSION}"
        )
    while version < CURRENT_VERSION:
        manifest = MIGRATIONS[version](manifest)
        version = manifest["schema_version"]
    return manifest


def load_scene(
    path: Union[str, Path] = DEFAULT_PATH, into: Optional[Scene] = None, *, device="cuda"
) -> Scene:
    """Load a checkpoint, migrating old schemas, into a new scene that
    computes on ``device``. With ``into``, loaded objects are ID-rebased
    above the live counter and merged into ``into``, which keeps its own
    device."""
    path = Path(path)
    with zipfile.ZipFile(path, "r") as zf:
        manifest = json.loads(zf.read("manifest.json"))
        manifest = _upgrade(manifest)

        def arr(name):
            with zf.open(name + ".npy") as f:
                return np.load(_io.BytesIO(f.read()))

        rooms: Dict[int, Room] = {}
        for rid_str, rm in manifest["rooms"].items():
            key = f"room{rid_str}"
            cloud = Cloud(
                cloud_id=rm["cloud_id"],
                points=arr(f"{key}/cloud_points").astype(np.float32),
                one_color=tuple(rm["cloud_one_color"]) if rm["cloud_one_color"] else None,
                colors=arr(f"{key}/cloud_colors") if rm["has_colors"] else None,
            )
            planes = [
                Plane(
                    plane_id=pm["id"],
                    normal=np.asarray(pm["normal"], np.float32),
                    d=float(pm["d"]),
                    color=tuple(pm["color"]),
                    bounds=arr(f"{key}/plane{pi}/bounds").astype(np.float32),
                )
                for pi, pm in enumerate(rm["planes"])
            ]
            room = Room(
                room_id=rm["id"],
                planes=planes,
                cloud=cloud,
                corners=[(i, np.asarray(c, np.float32)) for i, c in rm["corners"]],
                suggested_corners=[
                    (i, np.asarray(c, np.float32)) for i, c in rm["suggested_corners"]
                ],
                proj=arr(f"{key}/proj"),
                name=rm["name"],
            )
            rooms[room.room_id] = room

        free_planes = {
            pm["id"]: Plane(
                plane_id=pm["id"],
                normal=np.asarray(pm["normal"], np.float32),
                d=float(pm["d"]),
                color=tuple(pm["color"]),
                bounds=arr(f"free_plane{pm['id']}/bounds").astype(np.float32),
            )
            for pm in manifest.get("free_planes", [])
        }

    walls = [
        (Axis(w[0]), WallRelation(w[1], w[2]), int(w[3]), int(w[4]))
        for w in manifest["connected_walls"]
    ]

    if into is None:
        scene = Scene(
            rooms=rooms,
            connected_walls=walls,
            next_id=manifest["next_id"],
            planes=free_planes,
            device=str(device),
        )
        return scene

    # Merge with ID rebasing: bump every loaded ID by the live next_id.
    bump = into.next_id
    max_id = bump
    for room in rooms.values():
        bumped = room.bump_ids(bump)
        into.rooms[bumped.room_id] = bumped
        max_id = max(max_id, max(bumped.get_ids()))
    for p in free_planes.values():
        bumped_p = p.bump_ids(bump)
        into.planes[bumped_p.plane_id] = bumped_p
        max_id = max(max_id, bumped_p.plane_id)
    for axis, rel, p1, p2 in walls:
        into.connected_walls.append((axis, rel, p1 + bump, p2 + bump))
    into.next_id = max_id + 1
    return into
