"""Scan traffic: a recorded depth stream scanned into a room directory,
scan after scan.

A closed loop, as the command line's ``scan`` runs: each scan is one
``scan_to_room_dir`` call, which starts a fresh volume at the stream's
first true pose, fuses every frame on the kernel path and then writes
the room directory (clouds, planes.txt and hulls, trajectory, mesh)
with the configuration's export settings, into a directory under the
run's temporary directory (no fsync, as the command line writes; each
scan writes over the last one's files). Scans run back to back until
the window's seconds are spent, and the window ends when the directory
of the scan running then is written; a traced run adds one scan under
the profiler after it. No checkpoint is written.

The frames are made once in set-up, as the orbit traffic's: rendered
from the traffic's world, whose room and furniture are first stretched
by ``scale_xz`` along x and z, at the orbit's poses, with the
configuration's sensor noise drawn from the seed, rounded to whole
millimetres and held as a recorded stream loads them (host float32
metres). A ``DepthStream`` that stamps each frame's hand-over on the
host clock and, when the program asks for the next frame, records a
CUDA event that ends the frame before, hands them to the program.

What the window yields: every frame's hand-over time and end event, and
every scan's trajectory; the last scan's room directory. That
directory is compared with the plain reference (``reference/scan.py``),
and every other scan's trajectory with the last one's, bit for bit (a
scan whose trajectory differs is replayed by the reference too).
"""

from __future__ import annotations

import atexit
import gc
import inspect
import random
import shutil
import tempfile
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import torch

from harness import spec, synth
from harness.trace import Tracer
from reference import orbit as ref_orbit
from reference import scan as ref_scan

_orbit = spec.driver("orbit")


def world(traffic: dict):
    """(half_dims (3,), boxes (B, 2, 3)) of the traffic's world, every x
    and z coordinate times ``scale_xz``."""
    half, boxes = synth.WORLDS[traffic["world"]]()
    s = float(traffic.get("scale_xz", 1.0))
    half, boxes = half.copy(), boxes.copy()
    half[[0, 2]] *= s
    boxes[:, :, [0, 2]] *= s
    return half, boxes


def depth_stream_mm(cam: dict, poses: np.ndarray, half: np.ndarray, boxes: np.ndarray,
                    noise_at_2m: float, seed: int, device) -> torch.Tensor:
    """(N, H, W) int16 millimetre frames of the room ``half``, ``boxes``
    at ``poses``: ``harness/synth.depth_stream_mm`` for a given room (the
    same rendering, noise and rounding)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 63))
    h = torch.as_tensor(half, device=device)
    b = torch.as_tensor(boxes, device=device)
    pose_t = torch.as_tensor(poses, dtype=torch.float32, device=device)
    depth = torch.stack([synth.render_depth(cam, pose_t[k], h, b) for k in range(len(poses))])
    if noise_at_2m > 0:
        n = torch.randn(depth.shape, generator=gen, device=device, dtype=torch.float32)
        hd = depth * 0.5
        depth = torch.where(depth > 0, depth + noise_at_2m * n * hd * hd, depth)
    return torch.round(depth * 1000.0).clamp(0, 32767).to(torch.int16)


def make_inputs(config: dict, traffic: dict, seed: int, device) -> SimpleNamespace:
    """The stream: (N, 4, 4) true poses and the (N, H, W) host float32
    metre frames, as ``capture/replay.load_stream`` makes them from
    millimetres."""
    poses = synth.orbit_poses(int(traffic["frames"]), float(traffic["radius_m"]),
                              float(traffic["yaw_range_rad"]), float(traffic["pitch_rad"]))
    half, boxes = world(traffic)
    mm = depth_stream_mm(config["camera"], poses, half, boxes,
                         float(config["sensor_noise"]["sigma_at_2m_m"]), seed, device)
    scale = float(config["camera"]["depth_scale"])
    frames = mm.cpu().numpy().astype(np.float32) * scale
    return SimpleNamespace(poses=poses, frames=frames)


def settings(config: dict) -> ref_scan.Settings:
    """The export's settings: the configuration's ``export``, else the
    port's defaults (``Config().ransac`` and ``scan_to_room_dir``'s)."""
    from housescan_tpu_torch.config import Config
    from housescan_tpu_torch.kinfu.scan import scan_to_room_dir

    e = config.get("export", {})
    r = dict(vars(Config().ransac), **e.get("ransac", {}))
    arg = inspect.signature(scan_to_room_dir).parameters
    return ref_scan.Settings(
        max_points_full=int(e.get("max_points_full", arg["max_points_full"].default)),
        downsample_to=int(e.get("downsample_to", arg["downsample_to"].default)),
        max_planes=int(r["max_planes"]), n_hypotheses=int(r["n_hypotheses"]),
        inlier_threshold=float(r["inlier_threshold"]),
        min_inlier_fraction=float(r["min_inlier_fraction"]),
    )


def program_config(config: dict, s: ref_scan.Settings):
    """The port's ``Config`` of a configuration file."""
    from housescan_tpu_torch.config import (CameraConfig, Config, IcpConfig, RansacConfig,
                                            TsdfConfig)

    c, v, icp = config["camera"], config["volume"], config["icp"]
    return Config(
        camera=CameraConfig(width=c["width"], height=c["height"], fx=c["fx"], fy=c["fy"],
                            cx=c["cx"], cy=c["cy"], depth_scale=c["depth_scale"],
                            z_min=c["z_min"]),
        tsdf=TsdfConfig(resolution=int(v["resolution"]), size_m=float(v["size_m"]),
                        trunc_dist=float(v["trunc"]), max_weight=float(v["max_weight"]),
                        dtype=v["dtype"]),
        icp=IcpConfig(iterations=tuple(icp["iterations"]),
                      dist_threshold=float(icp["dist_threshold"]),
                      angle_threshold=float(icp["angle_threshold"])),
        ransac=RansacConfig(n_hypotheses=s.n_hypotheses, inlier_threshold=s.inlier_threshold,
                            max_planes=s.max_planes, min_inlier_fraction=s.min_inlier_fraction),
    )


def timed_stream(frames: np.ndarray, intr, rec: SimpleNamespace, clock):
    """A ``DepthStream`` over ``frames`` that appends each frame's
    hand-over (host clock) to ``rec.hand`` and, when the next frame is
    asked for (or the stream ends), a mark of the frame's end to
    ``rec.ends``."""
    from housescan_tpu_torch.capture.replay import DepthStream

    class TimedStream(DepthStream):
        def __iter__(self):
            for frame in self.frames:
                rec.hand.append(time.perf_counter())
                yield frame
                rec.ends.append(clock.mark())

    return TimedStream(frames=frames, intrinsics=intr)


class Program:
    """The system under test: ``scan_to_room_dir`` with a configuration's
    settings. ``volume_dtype`` ``torch.bfloat16`` makes the control: the
    same scan and export on a bfloat16 volume (``scan_to_room_dir``
    fuses into float32 only, so the control runs its loop here)."""

    def __init__(self, config: dict, s: ref_scan.Settings, device, volume_dtype=None):
        from housescan_tpu_torch.ops import cuda_lib

        self.cuda_lib = cuda_lib
        self.config, self.settings, self.device = config, s, device
        self.cfg = program_config(config, s)
        self.intr = _orbit.intrinsics(config)
        self.volume_dtype = volume_dtype

    def scan(self, stream, out: Path, init_pose) -> Path:
        s = self.settings
        if self.volume_dtype is None:
            from housescan_tpu_torch.kinfu.scan import scan_to_room_dir

            return scan_to_room_dir(stream, out, self.cfg, init_pose=init_pose,
                                    max_points_full=s.max_points_full,
                                    downsample_to=s.downsample_to, write_mesh=True,
                                    device=self.device)
        return self._control(stream, out, init_pose)

    def _control(self, stream, out: Path, init_pose) -> Path:
        from housescan_tpu_torch.kinfu.pipeline import kinfu_init, kinfu_step
        from housescan_tpu_torch.kinfu.scan import write_room_outputs

        cfg, s, dev = self.cfg, self.settings, self.device
        state = kinfu_init(self.intr, resolution=cfg.tsdf.resolution, size_m=cfg.tsdf.size_m,
                           trunc=cfg.tsdf.trunc_dist, init_pose=init_pose,
                           dtype=self.volume_dtype, device=dev)
        poses = []
        for frame in stream:
            depth = torch.from_numpy(frame)
            if dev.type == "cuda":
                depth = depth.pin_memory().to(dev, non_blocking=True)
            state = kinfu_step(state, depth, self.intr, iterations=cfg.icp.iterations,
                               dist_threshold=cfg.icp.dist_threshold,
                               angle_threshold=cfg.icp.angle_threshold,
                               max_weight=cfg.tsdf.max_weight, z_min=cfg.camera.z_min)
            poses.append(state.pose)
        return write_room_outputs(state.volume, list(torch.stack(poses).cpu().numpy()), out,
                                  config=cfg, icp_rmse=float(state.last_rmse),
                                  max_points_full=s.max_points_full,
                                  downsample_to=s.downsample_to, write_mesh=True)


def scan_once(prog: Program, inputs, room: Path, rec: SimpleNamespace, clock) -> np.ndarray:
    """One scan into ``room``, its frames stamped into ``rec``; returns
    its trajectory."""
    prog.scan(timed_stream(inputs.frames, prog.intr, rec, clock), room, inputs.poses[0])
    return ref_scan.read_trajectory(room)


def run_window(prog: Program, inputs, seconds: float, trace: bool, room: Path):
    """Scans back to back for ``seconds``; with ``trace`` one more scan
    follows under the profiler. Returns the window's record."""
    dev = prog.device
    rec = SimpleNamespace(hand=[], ends=[])
    traced, trajs, scan_end = [], [], []
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
        with span("scan"):
            trajs.append(scan_once(prog, inputs, room, rec, clock))
        traced += [tracing] * (len(rec.hand) - n0)
        scan_end.append(time.perf_counter())
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
        seconds=t1 - t0, frames=len(rec.hand), scans=len(trajs),
        frame_s=[d - h for d, h in zip(done, rec.hand)], traced=traced, trajectories=trajs,
        room=room, tracer=tracer, counts=counts,
        scan_s=[b - a for a, b in zip([t0] + scan_end[:-1], scan_end)],
    )


def check(prog: Program, inputs, win, seed: int, max_replays: int = 1):
    """The numbers that decide ``correct``: the last scan's room directory
    against the reference, and every other scan's trajectory against the
    last one's (a scan that differs is replayed by the reference as well,
    up to ``max_replays`` of them drawn from the seed). Returns (numbers,
    scans replayed, scans identical to the last)."""
    dev = prog.device
    frames = torch.from_numpy(inputs.frames).to(dev)
    init = torch.as_tensor(inputs.poses[0], dtype=torch.float32, device=dev)
    nums = ref_scan.check(frames, win.room, init, prog.config, prog.settings)
    last = win.trajectories[-1]
    differing = [p for p in range(win.scans - 1) if not np.array_equal(win.trajectories[p], last)]
    random.Random(seed).shuffle(differing)
    for p in differing[:max_replays]:
        poses = win.trajectories[p]
        other = ref_orbit.PassOut(torch.as_tensor(poses, device=dev),
                                  torch.as_tensor(ref_scan.tracked_of(poses), device=dev))
        want = ref_orbit.replay(frames, other, init, prog.config, want_end=False)
        for key, val in ref_orbit.numbers(other, want).items():
            nums[key] = max(nums[key], val)
    if len(differing) > max_replays:
        # scans left unreplayed: their poses are held to the last scan's
        gap = max(float(np.linalg.norm(win.trajectories[p][1:, 3, :3] - last[1:, 3, :3],
                                       axis=1).max()) for p in differing) * 1e3
        nums["pose_gap_mm"] = max(nums["pose_gap_mm"], gap)
    return nums, 1 + min(len(differing), max_replays), win.scans - 1 - len(differing)


def run(cell, seed: int, seconds: float, trace: bool, t_start: float, volume_dtype=None,
        device="cuda"):
    """Set-up, window, reading and check of one run of a scan cell
    (``volume_dtype`` "bfloat16" runs the control in the program's place;
    ``device`` the card, or the CPU in the CPU tests)."""
    dev = torch.device(device)
    config, traffic = cell.config, cell.traffic
    s = settings(config)
    dtype = {None: None, "float32": None, "bfloat16": torch.bfloat16}[volume_dtype]
    prog = Program(config, s, dev, dtype)
    inputs = make_inputs(config, traffic, seed, dev)
    tmp = Path(tempfile.mkdtemp(prefix="portbench_scan_"))
    atexit.register(shutil.rmtree, tmp, True)
    room = tmp / "room"
    # one whole scan: every shape the window uses, the kernels built or
    # loaded, the allocator's blocks in place
    scan_once(prog, inputs, room, SimpleNamespace(hand=[], ends=[]), _orbit._Clock(dev))
    if trace:  # the profiler's own start-up, outside the window
        warm_tracer = Tracer(dev)
        warm_tracer.start()
        with warm_tracer.span("warm"):
            torch.zeros(1, device=dev).add_(1)
        warm_tracer.stop()
    gc.collect()
    gc.freeze()  # set-up's objects stay out of the window's collections
    setup_s = time.time() - t_start
    win = run_window(prog, inputs, seconds, trace, room)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    failed = sum(int((~ref_scan.tracked_of(t)).sum()) for t in win.trajectories)
    t_check = time.perf_counter()
    nums, replayed, identical = check(prog, inputs, win, seed)
    check_s = time.perf_counter() - t_check
    return SimpleNamespace(
        setup_s=setup_s, window=win, memory_peak_bytes=peak, attempted=win.frames,
        failed=failed, numbers=nums, inputs=inputs, config=config, traffic=traffic,
        prog=prog, tmp=tmp,
        notes=dict(scans=win.scans, scans_replayed=replayed, scans_identical=identical,
                   window_s=win.seconds, check_s=check_s,
                   scan_host_s=[round(x, 4) for x in win.scan_s]),
    )
