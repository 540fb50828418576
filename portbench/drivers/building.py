"""Building traffic: a house scanned room by room at recorded poses, then
placed on its floors, building after building.

A closed loop, as the command line's ``scan-building --known-poses
--floors ...`` runs: each building is one ``scan_building`` call with
the arguments that command builds (``building_call``): every room's
recorded stream fused at its poses (no tracking) into a fresh volume and
written to its room directory without a mesh, then the assembly (corners,
one batched cuboid fit, the rooms on the Cantor grid of the
configuration's floors, walls connected, positions solved, the ``.xf``
files), into a directory under the run's temporary directory that every
building writes over. Buildings run back to back until the window's
seconds are spent, and the window ends when the ``.xf`` files of the
building running then are written; a traced run adds one building under
the profiler after it.

The frames are made once in set-up, each room its own world: the
traffic's room and furniture stretched along x and z by a factor drawn
for the room from the seed, rendered at the traffic's sweeps of poses
(the same for every room) with the configuration's sensor noise drawn
from the room's own seed, rounded to whole millimetres and held as a
recorded stream loads them (host float32 metres), through
``drivers/scan.depth_stream_mm``. A ``DepthStream`` that stamps each
frame's hand-over on the host clock and records a CUDA event that ends
the frame before, when the program asks for the next frame, hands them
to the program.

What the window yields: every frame's hand-over time and end event; each
building's fits and placements (the notes count the buildings equal to
the last); the last building's directory and scene, which are compared
with the plain reference (``reference/building.py``): the traffic's
``check_rooms_per_floor`` rooms of each floor, drawn from the seed, are
replayed room by room (all 23 take the reference about 2-3 minutes on
the card), and the assembly of every room is checked. A frame fails
when its room is left without a fitted cuboid.
"""

from __future__ import annotations

import atexit
import gc
import json
import random
import shutil
import tempfile
import time
from pathlib import Path
from types import SimpleNamespace
from typing import List

import numpy as np
import torch

from harness import spec, synth
from harness.trace import Tracer
from reference import building as ref_building

_orbit = spec.driver("orbit")
_scan = spec.driver("scan")


def layout(config: dict, traffic: dict) -> SimpleNamespace:
    """The building of the configuration: rooms, floors (rooms a floor),
    grid spacing (m), wall gap (m), mesh; the traffic names the same
    building, its floors as the command line's ``--floors``."""
    b = config["building"]
    floors = [int(x) for x in b["floors"]]
    given = dict(traffic, floors=[int(x) for x in traffic["floors"].split(",")])
    for key in ("rooms", "layout", "spacing_m", "gap_m", "write_mesh"):
        if given[key] != b[key]:
            raise ValueError(f"traffic {key} {given[key]!r} is not the configuration's {b[key]!r}")
    if given["floors"] != floors or sum(floors) != int(b["rooms"]) or b["layout"] != "grid":
        raise ValueError(f"floors {given['floors']} / {floors} do not hold {b['rooms']} rooms "
                         "on a grid")
    return SimpleNamespace(rooms=int(b["rooms"]), floors=floors, spacing=float(b["spacing_m"]),
                           gap=float(b["gap_m"]), write_mesh=bool(b["write_mesh"]))


def room_poses(traffic: dict) -> np.ndarray:
    """(F, 4, 4) poses of a room: the traffic's sweeps one after another,
    each ``frames`` poses on a circle of ``radius_m`` at ``height_m``,
    tilted by ``pitch_rad``."""
    out = []
    for sw in traffic["sweeps"]:
        p = synth.orbit_poses(int(sw["frames"]), float(sw["radius_m"]),
                              float(traffic["yaw_range_rad"]), float(sw["pitch_rad"]))
        p[:, 3, 1] = float(sw["height_m"])
        out.append(p)
    return np.concatenate(out)


def make_inputs(config: dict, traffic: dict, seed: int, device) -> SimpleNamespace:
    """Every room's stream: the shared (F, 4, 4) poses, and by room its
    name, stretch and (F, H, W) host float32 metre frames."""
    b = layout(config, traffic)
    poses = room_poses(traffic)
    if len(poses) != int(config["frames_per_room"]):
        raise ValueError(f"{len(poses)} poses a room; the configuration scans "
                         f"{config['frames_per_room']}")
    lo, hi = traffic["scale_xz"]
    scales = np.random.default_rng(int(seed) % (1 << 63)).uniform(lo, hi, b.rooms)
    half0, boxes0 = synth.WORLDS[traffic["world"]]()
    sigma = float(config["sensor_noise"]["sigma_at_2m_m"])
    depth_scale = float(config["camera"]["depth_scale"])
    rooms = []
    for r in range(b.rooms):
        half, boxes = half0.copy(), boxes0.copy()
        half[[0, 2]] *= scales[r]
        boxes[:, :, [0, 2]] *= scales[r]
        mm = _scan.depth_stream_mm(config["camera"], poses, half, boxes, sigma,
                                   int(seed) * 1009 + r, device)
        rooms.append(SimpleNamespace(name=f"room{r:02d}", scale=float(scales[r]),
                                     frames=mm.cpu().numpy().astype(np.float32) * depth_scale))
    return SimpleNamespace(poses=poses, rooms=rooms, building=b)


def room_scans(streams) -> List:
    """``RoomScan``s of (name, ``DepthStream`` with its poses) pairs, as
    the command line's ``scan-building --known-poses`` makes them."""
    from housescan_tpu_torch.kinfu.building import RoomScan

    return [RoomScan(name=name, stream=st, init_pose=st.poses[0], known_poses=st.poses)
            for name, st in streams]


def building_call(b: SimpleNamespace) -> dict:
    """``scan_building``'s keyword arguments for the building ``b``, as
    ``scan-building --known-poses --floors <b.floors> --gap <b.gap>``
    passes them (less ``progress``, its printing)."""
    return dict(mesh=None, checkpoint_every=0, resume=False, write_mesh=b.write_mesh, gap=b.gap,
                layout="grid", floors=list(b.floors))


class Program:
    """The system under test: ``scan_building`` with a configuration's
    settings. ``volume_dtype`` ``torch.bfloat16`` makes the control: every
    room fused on a bfloat16 volume in this driver's own loop and written
    with ``write_room_outputs``, then assembled by ``scan_building``
    resuming from the building checkpoint that lists them."""

    def __init__(self, config: dict, traffic: dict, s, device, volume_dtype=None):
        import dataclasses

        from housescan_tpu_torch.ops import cuda_lib

        self.cuda_lib = cuda_lib
        self.config, self.settings, self.device = config, s, device
        self.building = layout(config, traffic)
        cfg = _scan.program_config(config, s)
        self.cfg = dataclasses.replace(
            cfg, rooms=dataclasses.replace(cfg.rooms, grid_spacing=self.building.spacing))
        self.intr = _orbit.intrinsics(config)
        self.volume_dtype = volume_dtype

    def streams(self, inputs, rec, clock):
        out = []
        for room in inputs.rooms:
            st = _scan.timed_stream(room.frames, self.intr, rec, clock)
            st.poses = inputs.poses
            out.append((room.name, st))
        return out

    def build(self, inputs, out: Path, rec, clock):
        """One building into ``out``: ``scan_building``'s (scene, fitted
        rooms, directory)."""
        from housescan_tpu_torch.kinfu.building import scan_building

        rooms = room_scans(self.streams(inputs, rec, clock))
        kwargs = building_call(self.building)
        if self.volume_dtype is not None:
            self._control_rooms(rooms, out)
            kwargs["resume"] = True
        return scan_building(rooms, out, self.cfg, device=self.device, **kwargs)

    def _control_rooms(self, rooms, out: Path) -> None:
        from housescan_tpu_torch.kinfu.pipeline import kinfu_init, kinfu_step, pallas_supported
        from housescan_tpu_torch.kinfu.scan import write_room_outputs

        cfg, s, dev = self.cfg, self.settings, self.device
        use_pallas = pallas_supported(cfg.tsdf.resolution)
        for room in rooms:
            state = kinfu_init(self.intr, resolution=cfg.tsdf.resolution, size_m=cfg.tsdf.size_m,
                               trunc=cfg.tsdf.trunc_dist, init_pose=room.init_pose,
                               dtype=self.volume_dtype, device=dev)
            for k, frame in enumerate(room.stream):
                depth = torch.from_numpy(frame)
                if dev.type == "cuda":
                    depth = depth.pin_memory().to(dev, non_blocking=True)
                state = kinfu_step(state, depth, self.intr, max_weight=cfg.tsdf.max_weight,
                                   z_min=cfg.camera.z_min, use_pallas=use_pallas,
                                   forced_pose=room.known_poses[k])
            write_room_outputs(state.volume, list(room.known_poses), out / room.name, config=cfg,
                               max_points_full=s.max_points_full, downsample_to=s.downsample_to,
                               write_mesh=self.building.write_mesh)
            del state
        (out / "building_checkpoint.json").write_text(
            json.dumps({"rooms_done": [r.name for r in rooms]}))


def program_building(result, out: Path) -> ref_building.ProgramBuilding:
    """What the reference compares of a building: by room name its fitted
    corners before placement and its placed translation, and the wall
    connections (room, room, axis)."""
    scene = result[0]
    corners, trans = {}, {}
    for room in scene.rooms.values():
        name = Path(room.name).name
        t = np.asarray(room.proj, np.float64)[3, :3]
        trans[name] = t
        if room.corners:
            corners[name] = np.stack([c for _, c in room.corners]).astype(np.float64) - t
    conns = [(Path(scene.find_room_containing_plane(a).name).name,
              Path(scene.find_room_containing_plane(b).name).name, int(axis))
             for axis, _, a, b in scene.connected_walls]
    return ref_building.ProgramBuilding(corners, trans, conns, out)


def summary(got: ref_building.ProgramBuilding, bc: dict) -> tuple:
    """A building's result (``bc``: its building checkpoint), for holding
    every building to the last one."""
    return (json.dumps(bc, sort_keys=True),
            tuple((k, tuple(v.tolist())) for k, v in sorted(got.translation.items())),
            tuple(sorted(got.connections)))


def run_window(prog: Program, inputs, seconds: float, trace: bool, out: Path):
    """Buildings back to back for ``seconds``; with ``trace`` one more
    building follows under the profiler. Returns the window's record."""
    dev = prog.device
    rec = SimpleNamespace(hand=[], ends=[])
    traced, summaries, unfitted, ends = [], [], [], []
    tracer = None
    prog.cuda_lib.reset_counts()
    clock = _orbit._Clock(dev)
    t0 = clock.t0
    while True:
        tracing = trace and time.perf_counter() - t0 >= seconds
        if tracing:
            tracer = Tracer(dev)
            tracer.start()
        span = tracer.span if tracing else _orbit._no_span
        n0 = len(rec.hand)
        with span("building"):
            result = prog.build(inputs, out, rec, clock)
        traced += [tracing] * (len(rec.hand) - n0)
        ends.append(time.perf_counter())
        got = program_building(result, out)
        bc = json.loads((out / "building_checkpoint.json").read_text())
        summaries.append(summary(got, bc))
        unfitted.append([r.name for r in inputs.rooms if r.name not in bc.get("fit_rmse", {})])
        if tracing:
            tracer.stop()
            break
        if not trace and time.perf_counter() - t0 >= seconds:
            break
    clock.sync()
    t1 = time.perf_counter()
    counts = (dict(prog.cuda_lib.launch_counts), dict(prog.cuda_lib.plain_counts))
    done = [clock.host_time(m) for m in rec.ends]
    return SimpleNamespace(
        seconds=t1 - t0, frames=len(rec.hand), buildings=len(summaries),
        frame_s=[d - h for d, h in zip(done, rec.hand)], traced=traced, got=got,
        summaries=summaries, unfitted=unfitted, out=out, tracer=tracer, counts=counts,
        building_s=[b - a for a, b in zip([t0] + ends[:-1], ends)],
    )


def replayed_rooms(inputs, traffic: dict, seed: int) -> List[str]:
    """The rooms the reference replays: ``check_rooms_per_floor`` of each
    floor (all of a smaller floor), drawn from the seed; the assembly's
    check covers every room."""
    k = int(traffic["check_rooms_per_floor"])
    names = [r.name for r in inputs.rooms]
    rng = random.Random(seed)
    out, at = [], 0
    for n in inputs.building.floors:
        out += sorted(rng.sample(names[at:at + n], min(k, n)))
        at += n
    return out


def check(prog: Program, inputs, win, replay: List[str]):
    """The numbers that decide ``correct``, of the window's last building."""
    b = prog.building
    frames = {r.name: r.frames for r in inputs.rooms}
    return ref_building.check(frames, inputs.poses, win.got, [r.name for r in inputs.rooms],
                              replay, prog.config, prog.settings, b.floors, b.spacing, b.gap,
                              prog.device)


def run(cell, seed: int, seconds: float, trace: bool, t_start: float, volume_dtype=None,
        device="cuda"):
    """Set-up, window, reading and check of one run of a building cell
    (``volume_dtype`` "bfloat16" runs the control in the program's place;
    ``device`` the card, or the CPU in the CPU tests)."""
    dev = torch.device(device)
    config, traffic = cell.config, cell.traffic
    s = _scan.settings(config)
    dtype = {None: None, "float32": None, "bfloat16": torch.bfloat16}[volume_dtype]
    prog = Program(config, traffic, s, dev, dtype)
    inputs = make_inputs(config, traffic, seed, dev)
    tmp = Path(tempfile.mkdtemp(prefix="portbench_building_"))
    atexit.register(shutil.rmtree, tmp, True)
    out = tmp / "building"
    # one whole building: every shape the window uses, the kernels built or
    # loaded, the allocator's blocks in place
    prog.build(inputs, out, SimpleNamespace(hand=[], ends=[]), _orbit._Clock(dev))
    if trace:  # the profiler's own start-up, outside the window
        warm_tracer = Tracer(dev)
        warm_tracer.start()
        with warm_tracer.span("warm"):
            torch.zeros(1, device=dev).add_(1)
        warm_tracer.stop()
    gc.collect()
    gc.freeze()  # set-up's objects stay out of the window's collections
    setup_s = time.time() - t_start
    win = run_window(prog, inputs, seconds, trace, out)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    per_room = len(inputs.poses)
    failed = sum(len(u) for u in win.unfitted) * per_room
    t_check = time.perf_counter()
    replay = replayed_rooms(inputs, traffic, seed)
    nums = check(prog, inputs, win, replay)
    check_s = time.perf_counter() - t_check
    last = win.summaries[-1]
    return SimpleNamespace(
        setup_s=setup_s, window=win, memory_peak_bytes=peak, attempted=win.frames,
        failed=failed, numbers=nums, inputs=inputs, config=config, traffic=traffic,
        prog=prog, tmp=tmp,
        notes=dict(buildings=win.buildings,
                   buildings_identical=sum(sm == last for sm in win.summaries[:-1]),
                   rooms_replayed=len(replay), unfitted=win.unfitted[-1],
                   wall_connections=len(win.got.connections), window_s=win.seconds,
                   check_s=check_s, building_host_s=[round(x, 4) for x in win.building_s]),
    )
