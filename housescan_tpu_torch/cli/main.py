"""housescan_tpu_torch command line: ``python -m housescan_tpu_torch.cli``.

The port of ``housescan_tpu/cli/main.py``: the same 25 subcommands, flags,
messages and exit behaviour, on the port's modules. Every interactive
operation is a subcommand over a scene checkpoint file.

The one global option the reference lacks, ``--device``, names where the
work runs: ``cuda`` (the default) is the visible cards, and a mesh
(``scan-building --sharded``, ``refuse``) takes them, raising when there
are too few; one named device (``cpu``, ``cuda:0``) fills every entry of
a mesh. Nothing falls back to the CPU when no card is found.

The reference's ``enable_compilation_cache`` (JAX's persistent compile
cache) has no counterpart: the CUDA kernels build once into a cache keyed
by their sources' hash (``ops/cuda_lib.py``).

    scan            depth stream -> room directory        (was: external KinFu)
    detect-planes   cloud -> planes.txt + hulls           (was: external PCL tool)
    add-room        load a room dir into the scene        (was: '1'/'/' setups)
    suggest         corner suggestion (+auto-adopt 8)     (was: 'g')
    corner          corner from 3 planes                  (was: 'c')
    accept-corner   adopt one suggested corner            (was: click)
    plane-from-points  fit plane to picked points         (was: 'P')
    fit-cuboid      cuboid fit, replace geometry          (was: 'f')
    auto-align      align floor plane to +Y               (was: 'a')
    connect         connect two walls                     (was: 'w'/'W')
    disconnect      disconnect two walls                  (was: ctrl-W)
    optimize        global room-position least squares    (was: 'o')
    move / move-wall / swap / remove-ceiling              (was: arrows, menu)
    rotate          rotate a room to match two walls      (was: 'r')
    render          offscreen scene image                 (was: the GLUT display)
    duplicate-plane / delete-plane                        (was: 'D', delete)
    export          .xf files + pcl command lines + placed full-res models
                                                          (was: 'e' + external tools)
    save / load     checkpoint with migrations            (was: 's'/'l')
    demo            synthetic multi-room end-to-end run   (was: devSetup)
    info            scene summary                         (was: ShortShow dumps)
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np
import torch

DEFAULT_SCENE = "scene.housescan"


def _load_scene(path, device):
    from housescan_tpu_torch.io.checkpoint import load_scene
    from housescan_tpu_torch.rooms.types import Scene

    if Path(path).exists():
        return load_scene(path, device=device)
    return Scene(device=device)


def _save_scene(scene, path):
    from housescan_tpu_torch.io.checkpoint import save_scene

    save_scene(scene, path)


def _mesh_devices(device: str, n: int):
    """The ``devices`` of a mesh of ``n`` entries: None for ``cuda`` (the
    mesh takes the visible cards and raises when they are too few), else
    the named device ``n`` times."""
    return None if device == "cuda" else [torch.device(device)] * n


def _room_by_id(scene, room_id):
    if room_id is None:
        if len(scene.rooms) != 1:
            raise SystemExit(
                f"--room required ({len(scene.rooms)} rooms in scene: "
                f"{sorted(scene.rooms)})"
            )
        return next(iter(scene.rooms.values()))
    if room_id not in scene.rooms:
        raise SystemExit(f"no room {room_id}; have {sorted(scene.rooms)}")
    return scene.rooms[room_id]


def _scan_config(args):
    """Config with the volume geometry flags applied (None = defaults)."""
    trunc = getattr(args, "trunc", None)
    ransac_flags = [
        getattr(args, k, None)
        for k in ("ransac_hypotheses", "ransac_max_planes", "ransac_min_inliers")
    ]
    if (
        args.resolution is None and args.size_m is None and trunc is None
        and all(v is None for v in ransac_flags)
    ):
        return None
    from dataclasses import replace

    from housescan_tpu_torch.config import Config

    cfg = Config()
    tsdf = cfg.tsdf
    if args.resolution is not None:
        tsdf = replace(tsdf, resolution=args.resolution)
    if args.size_m is not None:
        tsdf = replace(tsdf, size_m=args.size_m)
    if trunc is not None:
        tsdf = replace(tsdf, trunc_dist=trunc)
    voxel = tsdf.size_m / tsdf.resolution
    if tsdf.trunc_dist < voxel:
        print(
            f"WARNING: truncation {tsdf.trunc_dist*1000:.0f} mm is below "
            f"the voxel size {voxel*1000:.0f} mm — the TSDF band may hold "
            "no voxel centers and surface extraction will find nothing; "
            "pass --trunc >= ~1.5 voxels",
            file=sys.stderr,
        )
    ransac = cfg.ransac
    if ransac_flags[0] is not None:
        ransac = replace(ransac, n_hypotheses=ransac_flags[0])
    if ransac_flags[1] is not None:
        ransac = replace(ransac, max_planes=ransac_flags[1])
    if ransac_flags[2] is not None:
        ransac = replace(ransac, min_inlier_fraction=ransac_flags[2])
    return replace(cfg, tsdf=tsdf, ransac=ransac)


def _add_volume_flags(p):
    p.add_argument(
        "--resolution", type=int, default=None, metavar="N",
        help="TSDF voxels per side (default 512; a multiple of 128 takes "
        "the kernel path)",
    )
    p.add_argument(
        "--size-m", type=float, default=None, metavar="M",
        help="TSDF cube edge in meters (default 3.0)",
    )
    p.add_argument(
        "--trunc", type=float, default=None, metavar="M",
        help="TSDF truncation distance in meters (default 0.03; keep it "
        ">= ~1.5 voxels or the band holds no voxel centers)",
    )
    p.add_argument(
        "--ransac-hypotheses", type=int, default=None, metavar="N",
        help="RANSAC plane hypotheses (default 512)",
    )
    p.add_argument(
        "--ransac-max-planes", type=int, default=None, metavar="N",
        help="max detected planes per room (default 8)",
    )
    p.add_argument(
        "--ransac-min-inliers", type=float, default=None, metavar="F",
        help="min inlier fraction per plane (default 0.05; lower it for "
        "coarse/furnished scans whose small faces fall under the bar)",
    )


def cmd_scan(args):
    from housescan_tpu_torch.kinfu.scan import scan_to_room_dir

    if args.live:
        from housescan_tpu_torch.capture.live import LiveStream, open_live_source

        src = open_live_source(realtime=args.realtime)
        if src is None:
            raise SystemExit(
                "no live depth device (set HOUSESCAN_FAKE_DEVICE to a "
                "recorded stream to test the live path)"
            )
        stream = LiveStream(src, max_frames=args.max_frames)
    else:
        if not args.stream:
            raise SystemExit("scan needs a stream file (or --live)")
        from housescan_tpu_torch.capture.replay import load_stream

        stream = load_stream(args.stream)
    out = scan_to_room_dir(
        stream,
        args.out,
        config=_scan_config(args),
        write_mesh=args.mesh,
        progress=True,
        checkpoint_every=args.checkpoint_every,
        resume=args.resume,
        device=args.device,
    )
    if args.live:
        src.stop()
        print(
            f"live scan: fused {src.frames_read} frames "
            f"(dropped {src.dropped}) -> {out}"
        )
    else:
        print(f"scanned {len(stream)} frames -> {out}")


def cmd_scan_building(args):
    from housescan_tpu_torch.capture.replay import load_stream
    from housescan_tpu_torch.kinfu.building import RoomScan, scan_building

    rooms = []
    for s in args.streams:
        stream = load_stream(s)
        kp = stream.poses if args.known_poses else None
        if args.known_poses and kp is None:
            raise SystemExit(f"{s}: stream has no recorded poses "
                             "(--known-poses needs them)")
        rooms.append(
            RoomScan(
                name=Path(s).stem,
                stream=stream,
                init_pose=None if kp is None else kp[0],
                known_poses=kp,
            )
        )
    mesh = None
    if args.sharded:
        from housescan_tpu_torch.parallel import make_mesh

        mesh = make_mesh(devices=_mesh_devices(args.device, 1))
    floors = (
        [int(x) for x in args.floors.split(",")]
        if "," in args.floors
        else int(args.floors)
    )
    n_floors = len(floors) if isinstance(floors, list) else floors
    layout = args.layout
    if n_floors > 1 and layout == "chain":
        layout = "grid"  # floors only exist on the grid layout
    scene, fitted, out = scan_building(
        rooms,
        args.out,
        config=_scan_config(args),
        mesh=mesh,
        checkpoint_every=args.checkpoint_every,
        resume=args.resume,
        progress=True,
        write_mesh=args.mesh,
        gap=args.gap,
        layout=layout,
        floors=floors,
        device=args.device,
    )
    _save_scene(scene, args.scene)
    print(
        f"scanned {len(rooms)} rooms -> {out} "
        f"({len(fitted)} fitted); scene saved to {args.scene}"
    )


def cmd_refuse(args):
    """Offline DP x SP re-fuse: N recorded streams at recorded (or
    offline-refined) trajectories, all rooms simultaneously on a 2-D
    (rooms x slab) device mesh (parallel/refuse.py)."""
    from housescan_tpu_torch.capture.replay import load_stream
    from housescan_tpu_torch.kinfu.scan import write_room_outputs
    from housescan_tpu_torch.parallel import make_mesh2d, refuse_rooms_2d

    streams = [load_stream(s) for s in args.streams]
    trajs = [np.load(t)["poses"] for t in args.trajectories]
    if len(streams) != len(trajs):
        raise SystemExit(
            f"{len(streams)} streams but {len(trajs)} trajectories"
        )
    intr = streams[0].intrinsics
    n_frames = max(len(s) for s in streams)
    h, w = intr.height, intr.width
    frames, padded_trajs = [], []
    for s, t in zip(streams, trajs):
        f = np.stack(list(s))
        if len(f) != len(t):
            raise SystemExit(
                f"stream has {len(f)} frames but trajectory {len(t)} poses"
            )
        pad = n_frames - len(f)
        if pad:  # zero frames integrate as no-ops
            f = np.concatenate([f, np.zeros((pad, h, w), np.float32)])
            t = np.concatenate([t, np.repeat(t[-1:], pad, axis=0)])
        frames.append(f)
        padded_trajs.append(np.asarray(t, np.float32))
    trajs = padded_trajs
    n_rooms = len(frames)
    if args.devices:
        r, s = (int(x) for x in args.devices.split("x"))
    else:
        r = n_rooms
        visible = torch.cuda.device_count() if args.device == "cuda" else 1
        s = max(visible // n_rooms, 1)
    mesh2d = make_mesh2d(r, s, devices=_mesh_devices(args.device, r * s))
    from housescan_tpu_torch.config import Config

    cfg = _scan_config(args) or Config()
    vols = refuse_rooms_2d(
        mesh2d, frames, trajs, intr,
        resolution=cfg.tsdf.resolution, size_m=cfg.tsdf.size_m,
        trunc=cfg.tsdf.trunc_dist,
    )
    out = Path(args.out)
    for k, (vol, stream_path) in enumerate(zip(vols, args.streams)):
        name = Path(stream_path).stem
        orig = np.load(args.trajectories[k])["poses"]
        write_room_outputs(
            vol, list(orig), out / name, config=cfg,
            write_mesh=args.mesh,
        )
        print(f"re-fused {name} -> {out / name}")
    print(f"{n_rooms} rooms re-fused on a {r}x{s} rooms-x-slab mesh")


def cmd_detect_planes(args):
    from housescan_tpu_torch.io.pcd import load_pcd
    from housescan_tpu_torch.kinfu.ransac import detect_planes_to_dir

    cloud = load_pcd(args.cloud)
    points = torch.as_tensor(cloud.points, device=args.device)
    det = detect_planes_to_dir(points, Path(args.cloud).parent)
    print(f"detected {int(det.n_planes)} planes")


def cmd_add_room(args):
    from housescan_tpu_torch.rooms import load_room

    scene = _load_scene(args.scene, args.device)
    room = load_room(scene, args.room_dir)
    if args.grid_slot is not None:
        from housescan_tpu_torch.rooms import translate_room

        k = args.grid_slot
        # Cantor-diagonal grid placement (ref Main.hs:2328-2331, :2504)
        pairs = [(a, n - 1 - a) for n in range(1, 50) for a in range(n)]
        gx, gz = pairs[k]
        spacing = args.grid_spacing
        room = translate_room(room, np.array([gx * spacing, 0, gz * spacing], np.float32),
                              device=scene.device)
        scene.update_room(room)
    _save_scene(scene, args.scene)
    print(f"room {room.room_id} added ({len(room.cloud.points)} pts, "
          f"{len(room.planes)} planes)")


def cmd_suggest(args):
    from housescan_tpu_torch.rooms import suggest_corners

    scene = _load_scene(args.scene, args.device)
    room = _room_by_id(scene, args.room)
    room = suggest_corners(scene, room, cutoff_factor=args.cutoff)
    _save_scene(scene, args.scene)
    print(
        f"room {room.room_id}: {len(room.corners)} corners, "
        f"{len(room.suggested_corners)} suggestions"
    )


def cmd_fit_cuboid(args):
    from housescan_tpu_torch.rooms import fit_cuboid_to_room

    scene = _load_scene(args.scene, args.device)
    room = _room_by_id(scene, args.room)
    result = fit_cuboid_to_room(scene, room)
    if result is None:
        raise SystemExit("not enough room corners; need 8 (run `suggest` first)")
    _, rmse, steps = result
    _save_scene(scene, args.scene)
    print(f"fit cuboid in {steps} steps, RMSE: {rmse:.6f} m")


def cmd_auto_align(args):
    from housescan_tpu_torch.rooms import auto_align_floor

    scene = _load_scene(args.scene, args.device)
    room = _room_by_id(scene, args.room)
    if auto_align_floor(scene, room) is None:
        raise SystemExit("room has no planes")
    _save_scene(scene, args.scene)
    print("aligned floor to +Y")


def cmd_connect(args):
    from housescan_tpu_torch.rooms import connect_walls
    from housescan_tpu_torch.rooms.types import WallRelation

    scene = _load_scene(args.scene, args.device)
    rel = WallRelation.same() if args.same else WallRelation.opposite(args.thickness)
    axis = connect_walls(scene, args.plane1, args.plane2, rel)
    if axis is None:
        raise SystemExit("could not connect: planes not walls of two rooms, or axes disagree")
    _save_scene(scene, args.scene)
    print(f"connected walls {args.plane1},{args.plane2} along {axis.name}")


def cmd_disconnect(args):
    from housescan_tpu_torch.rooms import disconnect_walls

    scene = _load_scene(args.scene, args.device)
    disconnect_walls(scene, args.plane1, args.plane2)
    _save_scene(scene, args.scene)
    print("disconnected")


def cmd_optimize(args):
    from housescan_tpu_torch.rooms import optimize_room_positions

    scene = _load_scene(args.scene, args.device)
    results = optimize_room_positions(scene)
    _save_scene(scene, args.scene)
    for axis, n, rmse in results:
        print(f"aligned {axis.name} component ({n} constraints) RMSE {rmse:.4f}")
    if not results:
        print("no wall connections to optimize")


def cmd_export(args):
    from housescan_tpu_torch.rooms import (
        export_all_room_pcl_transforms,
        export_all_room_xf_files,
        export_room_full_res,
    )

    scene = _load_scene(args.scene, args.device)
    out = Path(args.out)
    xfs = export_all_room_xf_files(scene, out / "xf")
    print(f"wrote {len(xfs)} .xf files to {out/'xf'}")
    for line in export_all_room_pcl_transforms(scene):
        print(line)
    if args.full_res:
        for rid, room in scene.rooms.items():
            src = Path(room.name) / "cloud_bin.pcd"
            if src.exists():
                dst = export_room_full_res(room, out / f"room{rid}-placed.ply",
                                           device=scene.device)
                print(f"placed full-res: {dst}")


def cmd_rotate(args):
    """The reference's 'r' key (rotateSelectedPlanes, ref Main.hs:977,
    :1629-1654): rotate plane 1's room so that wall faces opposite wall
    plane 2; a room-less plane 1 instead gains a rotated free-standing
    copy matching plane 2's normal."""
    from housescan_tpu_torch.rooms.align import rotate_room_to_match_walls
    from housescan_tpu_torch.rooms.types import Room

    scene = _load_scene(args.scene, args.device)
    try:
        got = rotate_room_to_match_walls(scene, args.plane1, args.plane2)
    except KeyError as e:
        raise SystemExit(str(e))
    _save_scene(scene, args.scene)
    if isinstance(got, Room):
        print(
            f"rotated room {got.room_id}: wall {args.plane1} now faces "
            f"opposite wall {args.plane2}"
        )
    else:
        print(
            f"plane {args.plane1} is in no room: added rotated copy as "
            f"free plane {got.plane_id}"
        )


def cmd_render(args):
    """Offscreen scene render (the reference's GLUT display pass,
    ref Main.hs:410-447) to PPM/PNG."""
    from housescan_tpu_torch.kinfu.camera import Intrinsics
    from housescan_tpu_torch.viewer import frame_scene, look_at_pose, render_scene

    scene = _load_scene(args.scene, args.device)
    if not scene.rooms and not scene.planes:
        raise SystemExit("scene is empty; nothing to render")
    w, h = args.width, args.height
    f = 0.5 * w / np.tan(np.radians(args.fov) / 2)
    intr = Intrinsics(w, h, f, f, w / 2.0, h / 2.0)
    if args.pose:
        pose = np.load(args.pose)
        pose = pose[args.pose_index] if pose.ndim == 3 else pose
    else:
        eye, target = frame_scene(scene)
        if args.eye:
            eye = _parse_xyz(args.eye)
        if args.look_at:
            target = _parse_xyz(args.look_at)
        pose = look_at_pose(eye, target)
    from housescan_tpu_torch.viewer.render import write_image

    img = render_scene(scene, pose, intr, point_px=args.point_px)
    out = write_image(args.out, img)
    print(f"rendered {len(scene.rooms)} rooms -> {out} ({w}x{h})")


def cmd_remove_ceiling(args):
    from housescan_tpu_torch.rooms import remove_ceiling

    scene = _load_scene(args.scene, args.device)
    room = _room_by_id(scene, args.room)
    scene.update_room(remove_ceiling(room, fraction=args.fraction, device=scene.device))
    _save_scene(scene, args.scene)
    print("ceiling removed")


def cmd_move(args):
    from housescan_tpu_torch.rooms import translate_room

    scene = _load_scene(args.scene, args.device)
    room = _room_by_id(scene, args.room)
    scene.update_room(
        translate_room(room, np.array([args.dx, args.dy, args.dz], np.float32),
                       device=scene.device)
    )
    _save_scene(scene, args.scene)
    print(f"moved room {room.room_id}")


def cmd_swap(args):
    from housescan_tpu_torch.rooms.manip import swap_room_positions

    scene = _load_scene(args.scene, args.device)
    for rid in (args.room1, args.room2):
        if rid not in scene.rooms:
            raise SystemExit(f"no room {rid}; have {sorted(scene.rooms)}")
    swap_room_positions(scene, args.room1, args.room2)
    _save_scene(scene, args.scene)
    print(f"swapped rooms {args.room1} and {args.room2}")


def cmd_duplicate_plane(args):
    from housescan_tpu_torch.rooms.manip import duplicate_plane

    scene = _load_scene(args.scene, args.device)
    try:
        dup = duplicate_plane(scene, args.plane)
    except KeyError as e:
        raise SystemExit(str(e))
    _save_scene(scene, args.scene)
    print(f"duplicated plane {args.plane} -> {dup.plane_id}")


def cmd_move_wall(args):
    from housescan_tpu_torch.rooms.manip import move_wall

    scene = _load_scene(args.scene, args.device)
    direction = np.array([args.dx, args.dy, args.dz], np.float32)
    if not np.linalg.norm(direction):
        raise SystemExit("direction must be nonzero")
    try:
        room = move_wall(scene, args.plane, direction, step=args.step)
    except KeyError as e:
        raise SystemExit(str(e))
    _save_scene(scene, args.scene)
    where = f"room {room.room_id}" if room is not None else "free-standing"
    print(f"moved wall {args.plane} ({where})")


def cmd_delete_plane(args):
    from housescan_tpu_torch.rooms.manip import delete_plane

    scene = _load_scene(args.scene, args.device)
    delete_plane(scene, args.plane)
    _save_scene(scene, args.scene)
    print(f"deleted plane {args.plane}")


def _parse_xyz(spec: str) -> np.ndarray:
    parts = spec.split(",")
    if len(parts) != 3:
        raise SystemExit(f"bad point {spec!r}; expected x,y,z")
    return np.array([float(x) for x in parts], np.float32)


def cmd_plane_from_points(args):
    from housescan_tpu_torch.rooms.corners import plane_from_points

    scene = _load_scene(args.scene, args.device)
    room = _room_by_id(scene, args.room)
    if args.points_file:
        pts = np.loadtxt(args.points_file, dtype=np.float32, ndmin=2)
        if pts.shape[1] != 3:
            raise SystemExit(f"{args.points_file}: expected 3 columns, got {pts.shape[1]}")
    else:
        pts = np.stack([_parse_xyz(s) for s in args.points])
    try:
        room = plane_from_points(scene, room, pts)
    except ValueError as e:
        raise SystemExit(str(e))
    _save_scene(scene, args.scene)
    p = room.planes[0]
    n = p.normal
    print(
        f"added plane {p.plane_id} to room {room.room_id}: "
        f"n=({n[0]:+.3f},{n[1]:+.3f},{n[2]:+.3f}) d={p.d:+.4f}"
    )


def cmd_corner(args):
    from housescan_tpu_torch.rooms.corners import add_corner_from_planes

    scene = _load_scene(args.scene, args.device)
    room = _room_by_id(scene, args.room)
    got = add_corner_from_planes(
        scene, room, (args.plane1, args.plane2, args.plane3)
    )
    if got is None:
        raise SystemExit(
            "no corner added (planes near-parallel, or the room already has 8 corners)"
        )
    _save_scene(scene, args.scene)
    print(f"room {got.room_id}: {len(got.corners)} corners")


def cmd_accept_corner(args):
    from housescan_tpu_torch.rooms.corners import accept_corner_suggestion

    scene = _load_scene(args.scene, args.device)
    room = _room_by_id(scene, args.room)
    if not any(sid == args.suggestion for sid, _ in room.suggested_corners):
        raise SystemExit(
            f"no suggestion {args.suggestion} in room {room.room_id}; have "
            f"{sorted(sid for sid, _ in room.suggested_corners)}"
        )
    got = accept_corner_suggestion(scene, room, args.suggestion)
    _save_scene(scene, args.scene)
    print(f"room {got.room_id}: {len(got.corners)} corners")


def cmd_info(args):
    scene = _load_scene(args.scene, args.device)
    print(f"scene: {len(scene.rooms)} rooms, {len(scene.connected_walls)} wall "
          f"connections, next_id={scene.next_id}")
    for rid, room in sorted(scene.rooms.items()):
        print(
            f"  room {rid}: {len(room.cloud.points)} pts, {len(room.planes)} planes, "
            f"{len(room.corners)} corners, {len(room.suggested_corners)} suggested"
            f"  [{room.name}]"
        )
        for p in room.planes:
            n = p.normal
            print(f"    plane {p.plane_id}: n=({n[0]:+.2f},{n[1]:+.2f},{n[2]:+.2f}) d={p.d:+.3f}")


def cmd_demo(args):
    """Synthetic end-to-end demo (the reference's devSetup, Main.hs:2334)."""
    from housescan_tpu_torch.rooms import (
        Scene,
        WallRelation,
        connect_walls,
        fit_cuboid_to_room,
        load_room,
        optimize_room_positions,
        suggest_corners,
        export_all_room_xf_files,
    )
    from housescan_tpu_torch.testing import make_synthetic_room_dir

    work = Path(args.out)
    scene = Scene(device=args.device)
    dims = (4.0, 2.5, 5.0)
    rooms = []
    for i in range(args.rooms):
        d = make_synthetic_room_dir(
            work / f"room{i}",
            dims=dims,
            seed=i,
            offset=np.array([i * (dims[0] + 0.35), 0, 0]),
        )
        r = load_room(scene, d)
        r = suggest_corners(scene, r)
        r, rmse, _ = fit_cuboid_to_room(scene, r)
        print(f"room {i}: cuboid RMSE {rmse*1000:.2f} mm")
        rooms.append(r)
    for a in range(len(rooms) - 1):
        pa = min(rooms[a].planes, key=lambda p: p.normal[0])
        pb = max(rooms[a + 1].planes, key=lambda p: p.normal[0])
        connect_walls(scene, pa.plane_id, pb.plane_id, WallRelation.opposite(0.1))
    results = optimize_room_positions(scene)
    for axis, n, rmse in results:
        print(f"aligned {axis.name} ({n} constraints) RMSE {rmse:.5f}")
    export_all_room_xf_files(scene, work / "xf")
    _save_scene(scene, args.scene)
    print(f"demo scene saved to {args.scene}")


def main(argv=None):
    parser = argparse.ArgumentParser(
        prog="housescan-tpu-torch",
        description="building-scale interior reconstruction on CUDA",
    )
    parser.add_argument("--scene", default=DEFAULT_SCENE, help="scene checkpoint file")
    parser.add_argument(
        "--device", default="cuda",
        help="where the work runs: cuda (the visible cards; a mesh takes "
        "them all) or one named device such as cuda:0 or cpu (which fills "
        "every entry of a mesh)",
    )
    sub = parser.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("scan", help="fuse a depth stream into a room directory")
    p.add_argument("stream", nargs="?", default=None,
                   help="recorded stream .npz (omit with --live)")
    p.add_argument("out")
    p.add_argument("--mesh", action="store_true")
    p.add_argument(
        "--live", action="store_true",
        help="capture from the live depth device (or the "
        "HOUSESCAN_FAKE_DEVICE recorded-device fixture)",
    )
    p.add_argument(
        "--max-frames", type=int, default=300, metavar="N",
        help="live capture length in frames",
    )
    p.add_argument(
        "--realtime", action="store_true",
        help="pace the live device at its native frame rate",
    )
    p.add_argument(
        "--checkpoint-every", type=int, default=0, metavar="N",
        help="write a resumable scan checkpoint every N frames",
    )
    p.add_argument(
        "--resume", action="store_true",
        help="resume from the room dir's scan checkpoint if present",
    )
    _add_volume_flags(p)
    p.set_defaults(fn=cmd_scan)

    p = sub.add_parser(
        "scan-building",
        help="fuse N room streams back-to-back into one arranged scene",
    )
    p.add_argument("out")
    p.add_argument("streams", nargs="+", metavar="stream.npz")
    p.add_argument("--mesh", action="store_true", help="write mesh.ply per room")
    p.add_argument(
        "--sharded", action="store_true",
        help="fuse big rooms on a volume sharded over all devices",
    )
    p.add_argument(
        "--checkpoint-every", type=int, default=0, metavar="N",
        help="frame-granular resumable checkpoint inside each room scan",
    )
    p.add_argument(
        "--resume", action="store_true",
        help="resume: skip finished rooms, continue the in-flight one",
    )
    p.add_argument(
        "--layout", choices=("chain", "grid"), default="chain",
        help="room arrangement: one X chain, or the reference's "
        "Cantor-diagonal 2-D grid (ref Main.hs:2328-2331)",
    )
    p.add_argument(
        "--known-poses", action="store_true",
        help="fuse at each stream's RECORDED camera poses instead of "
        "tracking (offline re-fuse of a pre-tracked scan)",
    )
    p.add_argument(
        "--floors", default="1", metavar="N|N1,N2,...",
        help="stack the grid into floors chained ceiling-to-floor (the "
        "3-floor houseSetup, ref Main.hs:2448-2517): an even count "
        "('3') or an explicit per-floor room split ('9,8,6'); implies "
        "--layout grid",
    )
    p.add_argument(
        "--gap", type=float, default=0.1, metavar="M",
        help="wall-to-wall thickness when chaining rooms (meters)",
    )
    _add_volume_flags(p)
    p.set_defaults(fn=cmd_scan_building)

    p = sub.add_parser(
        "refuse",
        help="re-fuse N recorded streams at recorded trajectories, all "
        "rooms at once on a 2-D rooms x slab device mesh",
    )
    p.add_argument("out")
    p.add_argument("streams", nargs="+", metavar="stream.npz")
    p.add_argument(
        "--trajectories", nargs="+", required=True, metavar="trajectory.npz",
        help="one per stream (a room dir's trajectory.npz, possibly "
        "offline-refined)",
    )
    p.add_argument(
        "--devices", default="", metavar="RxS",
        help="mesh shape rooms x slabs (default: n_rooms x "
        "n_devices//n_rooms)",
    )
    p.add_argument("--mesh", action="store_true", help="write mesh.ply per room")
    _add_volume_flags(p)
    p.set_defaults(fn=cmd_refuse)

    p = sub.add_parser("detect-planes", help="RANSAC planes for a cloud")
    p.add_argument("cloud")
    p.set_defaults(fn=cmd_detect_planes)

    p = sub.add_parser("add-room", help="load a room directory into the scene")
    p.add_argument("room_dir")
    p.add_argument("--grid-slot", type=int, default=None)
    p.add_argument("--grid-spacing", type=float, default=6.0)
    p.set_defaults(fn=cmd_add_room)

    p = sub.add_parser("suggest", help="suggest room corners")
    p.add_argument("--room", type=int, default=None)
    p.add_argument("--cutoff", type=float, default=1.2)
    p.set_defaults(fn=cmd_suggest)

    p = sub.add_parser("fit-cuboid", help="fit a cuboid to the room corners")
    p.add_argument("--room", type=int, default=None)
    p.set_defaults(fn=cmd_fit_cuboid)

    p = sub.add_parser("auto-align", help="align the floor plane to +Y")
    p.add_argument("--room", type=int, default=None)
    p.set_defaults(fn=cmd_auto_align)

    p = sub.add_parser("connect", help="connect two wall planes")
    p.add_argument("plane1", type=int)
    p.add_argument("plane2", type=int)
    p.add_argument("--same", action="store_true", help="same wall (not opposite)")
    p.add_argument("--thickness", type=float, default=0.1)
    p.set_defaults(fn=cmd_connect)

    p = sub.add_parser("disconnect", help="disconnect two wall planes")
    p.add_argument("plane1", type=int)
    p.add_argument("plane2", type=int)
    p.set_defaults(fn=cmd_disconnect)

    p = sub.add_parser("optimize", help="least-squares room positions")
    p.set_defaults(fn=cmd_optimize)

    p = sub.add_parser("export", help="export transforms and placed models")
    p.add_argument("--out", default="export")
    p.add_argument("--full-res", action="store_true")
    p.set_defaults(fn=cmd_export)

    p = sub.add_parser(
        "rotate",
        help="rotate plane 1's room so that wall faces opposite plane 2 "
        "(the 'r' key)",
    )
    p.add_argument("plane1", type=int)
    p.add_argument("plane2", type=int)
    p.set_defaults(fn=cmd_rotate)

    p = sub.add_parser("render", help="render the scene to an image")
    p.add_argument("--out", default="scene.png")
    p.add_argument("--width", type=int, default=1280)
    p.add_argument("--height", type=int, default=960)
    p.add_argument("--fov", type=float, default=60.0, help="horizontal FOV, degrees")
    p.add_argument(
        "--pose", default=None, metavar="POSE.npy",
        help="4x4 row-vector camera-to-world pose (or an (N,4,4) "
        "trajectory; see --pose-index)",
    )
    p.add_argument("--pose-index", type=int, default=0)
    p.add_argument("--eye", default=None, metavar="X,Y,Z")
    p.add_argument("--look-at", default=None, metavar="X,Y,Z")
    p.add_argument("--point-px", type=int, default=1)
    p.set_defaults(fn=cmd_render)

    p = sub.add_parser("remove-ceiling", help="drop top points to peek inside")
    p.add_argument("--room", type=int, default=None)
    p.add_argument("--fraction", type=float, default=0.2)
    p.set_defaults(fn=cmd_remove_ceiling)

    p = sub.add_parser("move", help="translate a room")
    p.add_argument("--room", type=int, default=None)
    p.add_argument("dx", type=float)
    p.add_argument("dy", type=float)
    p.add_argument("dz", type=float)
    p.set_defaults(fn=cmd_move)

    p = sub.add_parser("swap", help="swap two rooms' positions")
    p.add_argument("room1", type=int)
    p.add_argument("room2", type=int)
    p.set_defaults(fn=cmd_swap)

    p = sub.add_parser("duplicate-plane", help="duplicate a wall plane with a fresh ID")
    p.add_argument("plane", type=int)
    p.set_defaults(fn=cmd_duplicate_plane)

    p = sub.add_parser(
        "move-wall", help="move a wall plane, dragging its room corners"
    )
    p.add_argument("plane", type=int)
    p.add_argument("dx", type=float)
    p.add_argument("dy", type=float)
    p.add_argument("dz", type=float)
    p.add_argument("--step", type=float, default=0.01, help="meters per unit direction")
    p.set_defaults(fn=cmd_move_wall)

    p = sub.add_parser("delete-plane", help="delete a plane")
    p.add_argument("plane", type=int)
    p.set_defaults(fn=cmd_delete_plane)

    p = sub.add_parser(
        "plane-from-points", help="fit a plane to >=3 picked points"
    )
    p.add_argument("--room", type=int, default=None)
    p.add_argument(
        "points", nargs="*", metavar="X,Y,Z", help="picked points as x,y,z"
    )
    p.add_argument(
        "--points-file", default=None, help="text file with one x y z row per point"
    )
    p.set_defaults(fn=cmd_plane_from_points)

    p = sub.add_parser("corner", help="corner from 3 planes of one room")
    p.add_argument("--room", type=int, default=None)
    p.add_argument("plane1", type=int)
    p.add_argument("plane2", type=int)
    p.add_argument("plane3", type=int)
    p.set_defaults(fn=cmd_corner)

    p = sub.add_parser("accept-corner", help="adopt one suggested corner")
    p.add_argument("--room", type=int, default=None)
    p.add_argument("suggestion", type=int)
    p.set_defaults(fn=cmd_accept_corner)

    p = sub.add_parser("info", help="scene summary")
    p.set_defaults(fn=cmd_info)

    p = sub.add_parser("demo", help="synthetic multi-room end-to-end demo")
    p.add_argument("--rooms", type=int, default=3)
    p.add_argument("--out", default="demo_rooms")
    p.set_defaults(fn=cmd_demo)

    args = parser.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
