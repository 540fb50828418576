"""A building scan: rooms fused one after another into one scene
(``housescan_tpu/kinfu/building.py``).

  * each room fuses on the single-device pipeline (``kinfu/scan.py``),
    or, given a mesh and a volume of ``sharded_min_resolution`` or more,
    on the X-slab sharded step (``parallel/sharded.py``: the kernel path
    where the volume tiles over the mesh, packed, else the XLA path);
  * ``building_checkpoint.json`` lists the finished rooms, in the
    reference's schema, so a resumed run of either package skips them;
    the room in flight resumes from its scan checkpoint
    (``kinfu/scan_checkpoint.py``, the sharded route gathering its slabs
    into it);
  * then the assembly: corners a room, ONE batched cuboid fit for every
    room with 8 corners (``parallel.fit_cuboids_sharded`` on a mesh),
    walls chained, positions optimised, the scene's .xf exported.

With tracing on (``utils/metrics.GLOBAL_METRICS``) the call is the span
``building``: ``building.room`` a scanned room (its fusion steps and
export nest inside), then ``building.assembly`` with the children
``.load``, ``.fit``, ``.arrange``, ``.optimize`` and ``.xf``; it counts
``building.rooms``, ``building.fitted_rooms``,
``building.wall_connections`` and ``building.fit_iterations`` (the
longest instance of each Nelder-Mead stage, summed over the two; a
device value, read when drained), adding no host synchronisation.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from housescan_tpu_torch.capture.replay import DepthStream
from housescan_tpu_torch.config import Config
from housescan_tpu_torch.kinfu.scan import scan_to_room_dir, write_room_outputs
from housescan_tpu_torch.kinfu.scan_checkpoint import load_scan_state, save_scan_state
from housescan_tpu_torch.parallel.mesh import Mesh
from housescan_tpu_torch.utils.metrics import GLOBAL_METRICS


@dataclass
class RoomScan:
    """One room of a building scan. ``known_poses`` ((N, 4, 4)) fuses the
    frames at known poses instead of tracking, on either route."""

    name: str
    stream: DepthStream
    init_pose: Optional[np.ndarray] = None
    known_poses: Optional[np.ndarray] = None


def _scan_room_sharded(
    room: RoomScan,
    out_dir: Path,
    mesh: Mesh,
    config: Config,
    progress: bool = False,
    write_mesh: bool = False,
    checkpoint_every: int = 0,
    resume: bool = False,
) -> Path:
    """Fuse one room on the sharded volume and write its room directory.
    The slabs stay on the mesh for the whole stream; a checkpoint (every
    ``checkpoint_every`` frames) and the final export gather them. With
    ``resume`` the room continues from its checkpoint's next frame."""
    from housescan_tpu_torch.parallel.sharded import (
        make_sharded_step,
        sharded_kinfu_init,
        sharded_state_from_single,
        single_state_from_sharded,
    )

    intr = room.stream.intrinsics
    cfg = config.tsdf
    use_pallas = cfg.resolution % 128 == 0 and (cfg.resolution // 8) % mesh.size == 0
    ckpt = out_dir / "scan_checkpoint.npz"
    start_frame = 0
    poses: List[np.ndarray] = []
    state = None
    if resume and ckpt.exists():
        kstate, start_frame, trajectory = load_scan_state(ckpt, intr, device=mesh.devices[0])
        poses = list(trajectory)
        if len(poses) != start_frame:
            raise ValueError(f"scan checkpoint stores {len(poses)} poses but resumes at frame "
                             f"{start_frame}; refusing a misaligned trajectory")
        state = sharded_state_from_single(mesh, kstate, use_pallas)
        if progress:
            print(f"  [{room.name}] resuming sharded scan at frame {start_frame}")
    if state is None:
        state = sharded_kinfu_init(mesh, intr, resolution=cfg.resolution, size_m=cfg.size_m,
                                   trunc=cfg.trunc_dist, init_pose=room.init_pose,
                                   use_pallas=use_pallas)
    step = make_sharded_step(mesh, intr, use_pallas=use_pallas)
    new_poses = []
    for k, frame in enumerate(room.stream):
        if k < start_frame:
            continue
        forced = None if room.known_poses is None else room.known_poses[k]
        state = step(state, torch.from_numpy(np.asarray(frame, np.float32)), forced_pose=forced)
        new_poses.append(state.pose)
        if checkpoint_every and (k + 1) % checkpoint_every == 0:
            traj = poses + list(torch.stack(new_poses).cpu().numpy())
            save_scan_state(single_state_from_sharded(state), k + 1, intr, ckpt,
                            trajectory=np.stack(traj))
        if progress and k % 10 == 0:
            print(f"  [{room.name}] frame {k}/{len(room.stream)} (sharded)")
    if new_poses:
        poses += list(torch.stack(new_poses).cpu().numpy())
    return write_room_outputs(state.volume.gather(), poses, out_dir, config=config,
                              write_mesh=write_mesh)


def cantor_slots(n: int) -> List[Tuple[int, int]]:
    """The first ``n`` cells of the 2-D grid in Cantor-diagonal order,
    (0, 0), (1, 0), (0, 1), (2, 0), (1, 1), (0, 2), ...: the reference
    program's room layout (``diagonalPairs``)."""
    out: List[Tuple[int, int]] = []
    d = 0
    while len(out) < n:
        out.extend((d - i, i) for i in range(d + 1))
        d += 1
    return out[:n]


def cantor_slots_3d(n: int, floors) -> List[Tuple[int, int, int]]:
    """The first ``n`` (gx, floor, gz) cells: rooms fill the floors bottom
    up in contiguous runs, each floor laid out by ``cantor_slots``, so the
    floors' common slots stand above one another. ``floors`` is a count
    (rooms split evenly, rounded up) or the rooms of each floor."""
    per = [-(-n // floors)] * floors if isinstance(floors, int) else list(floors)
    if sum(per) < n:
        raise ValueError(f"floor split {per} holds {sum(per)} rooms < {n}")
    out: List[Tuple[int, int, int]] = []
    for f, count in enumerate(per):
        take = min(count, n - len(out))
        out.extend((gx, f, gz) for gx, gz in cantor_slots(take))
        if len(out) == n:
            break
    return out


def scan_building(
    rooms: Sequence[RoomScan],
    out_dir: Union[str, Path],
    config: Optional[Config] = None,
    mesh: Optional[Mesh] = None,
    sharded_min_resolution: int = 512,
    checkpoint_every: int = 0,
    resume: bool = False,
    progress: bool = False,
    write_mesh: bool = False,
    gap: float = 0.1,
    *,
    layout: str = "chain",
    floors=1,
    device="cuda",
):
    """Scan every room, then assemble, arrange, optimise and export.
    Returns ``(scene, fitted_rooms, out_dir)``.

    Rooms fuse on ``device`` (the card by default), or on ``mesh``'s
    sharded volume when one is given and the configured resolution is
    ``sharded_min_resolution`` or more; the assembly computes on
    ``device``. ``checkpoint_every`` / ``resume`` give every room a
    frame-granular resume, and ``out_dir/building_checkpoint.json`` skips
    finished rooms. ``gap`` is the wall-to-wall spacing of chained rooms.
    ``layout`` "chain" links the rooms along X; "grid" places them on the
    Cantor grid ``config.rooms.grid_spacing`` apart and chains every
    pair of neighbours along X and Z, and ``floors`` (a count or the
    rooms of each floor) stacks floors on Y (upper floors at more
    negative Y: world up is -Y), chaining ceilings to the floors above."""
    config = config or Config()
    device = torch.device(device)
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    bc_path = out_dir / "building_checkpoint.json"
    done: List[str] = []
    if resume and bc_path.exists():
        done = json.loads(bc_path.read_text()).get("rooms_done", [])
        if progress and done:
            print(f"building resume: rooms already scanned: {done}")

    use_sharded = mesh is not None and config.tsdf.resolution >= sharded_min_resolution
    with GLOBAL_METRICS.span("building"):
        room_dirs = []
        n_scanned = 0
        for room in rooms:
            rd = out_dir / room.name
            room_dirs.append(rd)
            if room.name in done and (rd / "planes.txt").exists():
                continue
            if progress:
                kind = "sharded" if use_sharded else "single-device"
                print(f"scanning {room.name} ({len(room.stream)} frames, {kind})")
            with GLOBAL_METRICS.span("building.room"):
                if use_sharded:
                    _scan_room_sharded(room, rd, mesh, config, progress=progress,
                                       write_mesh=write_mesh, checkpoint_every=checkpoint_every,
                                       resume=resume)
                else:
                    scan_to_room_dir(room.stream, rd, config=config, init_pose=room.init_pose,
                                     write_mesh=write_mesh, progress=progress,
                                     checkpoint_every=checkpoint_every, resume=resume,
                                     known_poses=room.known_poses, device=device)
                done.append(room.name)
                bc_path.write_text(json.dumps({"rooms_done": done}))
            n_scanned += 1
        GLOBAL_METRICS.count("building.rooms", n_scanned)
        with GLOBAL_METRICS.span("building.assembly"):
            scene, fitted = _assemble(rooms, room_dirs, done, bc_path, config, mesh, progress,
                                      gap, layout, floors, device)
    return scene, fitted, out_dir


def _assemble(rooms, room_dirs, done, bc_path, config, mesh, progress, gap, layout, floors,
              device):
    """``scan_building``'s assembly of the scanned room directories:
    returns ``(scene, fitted_rooms)``."""
    from housescan_tpu_torch.rooms import (
        Axis,
        Scene,
        WallRelation,
        adopt_bbox_corners,
        connect_walls,
        export_all_room_xf_files,
        load_room,
        optimize_room_positions,
        suggest_corners,
        translate_room,
    )
    from housescan_tpu_torch.rooms.cuboid import apply_cuboid_fit
    from housescan_tpu_torch.rooms.walls import best_axis
    from housescan_tpu_torch.solvers.cuboid_fit import fit_cuboid_batch_counted

    scene = Scene(device=str(device))
    with GLOBAL_METRICS.span("building.assembly.load"):
        loaded = []
        for rd in room_dirs:
            r = suggest_corners(scene, load_room(scene, rd))
            # more than 8 candidates (furniture planes): the 8 at the cloud's extremes
            loaded.append(adopt_bbox_corners(scene, r))

    # one batched cuboid fit for every room with 8 corners
    fit_rmse: dict = {}
    fit_idx = [i for i, r in enumerate(loaded) if len(r.corners) >= 8]
    fitted = list(loaded)
    with GLOBAL_METRICS.span("building.assembly.fit"):
        if fit_idx:
            batch = np.stack([np.stack([c for _, c in loaded[i].corners[:8]]) for i in fit_idx])
            batch = batch.astype(np.float32)
            if mesh is not None:
                from housescan_tpu_torch.parallel.rooms_batch import fit_cuboids_sharded

                fits = fit_cuboids_sharded(batch, mesh)
            else:
                fits, (n1, n2) = fit_cuboid_batch_counted(batch, device=device)
                if GLOBAL_METRICS.tracing:
                    GLOBAL_METRICS.count("building.fit_iterations", n1.max() + n2.max())
            params = fits.params.cpu().numpy()
            errors = fits.error.cpu().numpy()
            for row, i in enumerate(fit_idx):
                fitted[i] = apply_cuboid_fit(scene, loaded[i], params[row])
                fit_rmse[rooms[i].name] = float(np.sqrt(errors[row]))
                if progress:
                    print(f"  {rooms[i].name}: cuboid RMSE {fit_rmse[rooms[i].name] * 1000:.2f} mm")
    GLOBAL_METRICS.count("building.fitted_rooms", len(fit_idx))

    def connect_axis(ra, rb, axis_i):
        """ra's +axis wall to rb's -axis wall (inward normals: ra's plane
        of least normal component faces rb's of greatest). A room without
        corners, or without a wall on the axis, stays unconnected."""
        if not ra.corners or not rb.corners:
            return
        axis = (Axis.X, Axis.Y, Axis.Z)[axis_i]
        ca = [p for p in ra.planes if best_axis(p.normal) == axis]
        cb = [p for p in rb.planes if best_axis(p.normal) == axis]
        if not ca or not cb:
            return
        pa = min(ca, key=lambda p: p.normal[axis_i])
        pb = max(cb, key=lambda p: p.normal[axis_i])
        connect_walls(scene, pa.plane_id, pb.plane_id, WallRelation.opposite(gap))

    with GLOBAL_METRICS.span("building.assembly.arrange"):
        if layout == "grid":
            spacing = config.rooms.grid_spacing
            by_slot = {}
            for i, (gx, fl, gz) in enumerate(cantor_slots_3d(len(fitted), floors)):
                offset = np.array([gx * spacing, -fl * spacing, gz * spacing], np.float32)
                moved = translate_room(scene.rooms[fitted[i].room_id], offset, device=device)
                scene.update_room(moved)
                fitted[i] = moved
                by_slot[(gx, fl, gz)] = i
            for (gx, fl, gz), i in by_slot.items():
                for dx, dz, axis_i in ((1, 0, 0), (0, 1, 2)):
                    j = by_slot.get((gx + dx, fl, gz + dz))
                    if j is not None:
                        connect_axis(fitted[i], fitted[j], axis_i)
                # the room upstairs: its floor (the +Y face, facing down) meets
                # this room's ceiling
                j = by_slot.get((gx, fl + 1, gz))
                if j is not None:
                    connect_axis(fitted[j], fitted[i], 1)
        else:
            for a in range(len(fitted) - 1):
                connect_axis(fitted[a], fitted[a + 1], 0)
    GLOBAL_METRICS.count("building.wall_connections", len(scene.connected_walls))
    with GLOBAL_METRICS.span("building.assembly.optimize"):
        results = optimize_room_positions(scene)
    if progress:
        for axis, nc, rmse in results:
            print(f"  aligned {axis.name} ({nc} constraints) RMSE {rmse:.5f}")
    fitted = [scene.rooms[r.room_id] for r in fitted]

    with GLOBAL_METRICS.span("building.assembly.xf"):
        # the assembly's diagnostics: every stage shows that it ran
        bc_path.write_text(json.dumps({
            "rooms_done": done,
            "fit_rmse": fit_rmse,
            "n_wall_connections": len(scene.connected_walls),
            "optimize": [[axis.name, int(nc), float(rmse)] for axis, nc, rmse in results],
        }))
        export_all_room_xf_files(scene, bc_path.parent / "xf")
    return scene, fitted
