"""Orbit traffic: a recorded depth stream fused pass after pass.

A closed loop, as a scan runs: each pass is a fresh ``kinfu_init`` at the
stream's first pose (a new room scan), then every frame of the stream in
turn through ``kinfu_step`` on the kernel path, each call made as soon as
the last returned; frame 0 of a pass is fused at that pose without
tracking. The frames are made once in set-up: rendered from the
traffic's world and poses, with the configuration's sensor noise drawn
from the seed, rounded to whole millimetres and held on the host as a
camera's stream (int16 millimetres, the uint16 wire format's bits). A
frame is handed to the program at the host time its upload starts; it
is done when a CUDA event recorded right after its step completes.
Passes run back to back until the window's seconds are spent, and the
window ends with the pass that is running then; a traced run adds one
pass under the profiler after it.

What the window yields: every frame's hand-over time, host time in the
step, end event, pose and tracked flag; the last pass's final state. The
last pass is compared with the plain reference (``reference/orbit.py``),
and every other pass's poses with the last pass's, bit for bit (a pass
whose poses differ is replayed by the reference too).
"""

from __future__ import annotations

import contextlib
import gc
import random
import time
from types import SimpleNamespace

import torch

from harness import synth
from harness.trace import Tracer
from reference import orbit as ref_orbit


def intrinsics(config: dict):
    from housescan_tpu_torch.kinfu.camera import Intrinsics

    c = config["camera"]
    return Intrinsics(c["width"], c["height"], c["fx"], c["fy"], c["cx"], c["cy"])


def make_inputs(config: dict, traffic: dict, seed: int, device) -> SimpleNamespace:
    """The stream: (N, 4, 4) true poses and the (N, H, W) int16
    millimetre frames in pinned host memory."""
    poses = synth.orbit_poses(int(traffic["frames"]), float(traffic["radius_m"]),
                              float(traffic["yaw_range_rad"]), float(traffic["pitch_rad"]))
    noise = config["sensor_noise"]
    mm = synth.depth_stream_mm(config["camera"], poses, traffic["world"],
                               float(noise["sigma_at_2m_m"]), seed, device)
    host = torch.empty(mm.shape, dtype=torch.int16, pin_memory=device.type == "cuda")
    host.copy_(mm)
    return SimpleNamespace(poses=poses, frames_mm=host)


def to_metres(frame_mm: torch.Tensor, device, depth_scale: float) -> torch.Tensor:
    """A millimetre frame on ``device`` in float32 metres, as a recorded
    stream loads (``raw.astype(float32) * scale``)."""
    return frame_mm.to(device, non_blocking=True).to(torch.float32) * depth_scale


class Program:
    """The system under test: the port's fusion entry points, called with
    the arguments ``kinfu/scan.py`` passes."""

    def __init__(self, config: dict, device, volume_dtype=torch.float32):
        from housescan_tpu_torch.kinfu.pipeline import kinfu_init, kinfu_step
        from housescan_tpu_torch.ops import cuda_lib

        self.init, self.step, self.cuda_lib = kinfu_init, kinfu_step, cuda_lib
        self.intr = intrinsics(config)
        self.config = config
        self.device = device
        self.volume_dtype = volume_dtype
        v, icp = config["volume"], config["icp"]
        self.step_kwargs = dict(
            levels=int(icp["levels"]),
            iterations=tuple(icp["iterations"]),
            dist_threshold=float(icp["dist_threshold"]),
            angle_threshold=float(icp["angle_threshold"]),
            max_weight=float(v["max_weight"]),
            z_min=float(config["camera"]["z_min"]),
            use_pallas=True,
        )

    def fresh(self, init_pose):
        v = self.config["volume"]
        return self.init(self.intr, resolution=int(v["resolution"]), size_m=float(v["size_m"]),
                         trunc=float(v["trunc"]), init_pose=init_pose, dtype=self.volume_dtype,
                         device=self.device)

    def __call__(self, state, depth):
        return self.step(state, depth, self.intr, **self.step_kwargs)


@contextlib.contextmanager
def _no_span(name: str):
    yield


class _Clock:
    """Frame completion times on the host clock. On a card: a CUDA event
    recorded after the frame's step, read after the window against an
    event recorded at its start on an idle stream; on the CPU, whose
    operations are synchronous, the host time itself."""

    def __init__(self, device):
        self.cuda = device.type == "cuda"
        self.sync()
        if self.cuda:
            self.e0 = torch.cuda.Event(enable_timing=True)
            self.e0.record()
        self.t0 = time.perf_counter()

    def sync(self):
        if self.cuda:
            torch.cuda.synchronize()

    def mark(self):
        if not self.cuda:
            return time.perf_counter()
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def host_time(self, mark) -> float:
        return self.t0 + self.e0.elapsed_time(mark) * 1e-3 if self.cuda else mark


def warm(prog: Program, inputs, scale: float) -> None:
    """One whole pass: every shape the window uses, the kernels built or
    loaded, the allocator's blocks in place."""
    state = prog.fresh(inputs.poses[0])
    for j in range(inputs.frames_mm.shape[0]):
        state = prog(state, to_metres(inputs.frames_mm[j], prog.device, scale))
    del state
    _Clock(prog.device).sync()


def run_window(prog: Program, inputs, seconds: float, scale: float, trace: bool):
    """Passes back to back for ``seconds``; with ``trace`` one more pass
    follows under the profiler (the profiler slows the host from its
    start on, so the untraced passes come first). Returns the window's
    record."""
    dev = prog.device
    n = inputs.frames_mm.shape[0]
    cap = n * (int(seconds * 200.0 / n) + 2)
    poses_buf = torch.zeros((cap, 4, 4), dtype=torch.float32, device=dev)
    tracked_buf = torch.zeros((cap,), dtype=torch.bool, device=dev)
    hand, host_s, ends, traced, pass_end = [], [], [], [], []
    tracer = None
    prog.cuda_lib.reset_counts()
    clock = _Clock(dev)
    t0 = clock.t0
    k = 0
    state = None
    n_pass = 0
    while True:
        tracing = trace and time.perf_counter() - t0 >= seconds
        if tracing:
            tracer = Tracer(dev)
            tracer.start()
        span = tracer.span if tracing else _no_span
        with span("reset"):
            state = None  # the last pass's state goes before the next is made
            state = prog.fresh(inputs.poses[0])
        for j in range(n):
            if k == cap:
                raise RuntimeError(f"more than {cap} frames in {seconds} s: raise the buffer")
            th = time.perf_counter()
            with span("upload"):
                depth = to_metres(inputs.frames_mm[j], dev, scale)
            with span("step"):
                state = prog(state, depth)
            tr = time.perf_counter()
            poses_buf[k].copy_(state.pose)
            tracked_buf[k].copy_(state.last_tracked)
            hand.append(th)
            host_s.append(tr - th)
            ends.append(clock.mark())
            traced.append(tracing)
            k += 1
        n_pass += 1
        pass_end.append(time.perf_counter())
        if tracing:
            tracer.stop()
            break
        if not trace and time.perf_counter() - t0 >= seconds:
            break
    clock.sync()
    t1 = time.perf_counter()
    counts = (dict(prog.cuda_lib.launch_counts), dict(prog.cuda_lib.plain_counts))
    done = [clock.host_time(m) for m in ends]
    return SimpleNamespace(
        seconds=t1 - t0, frames=k, passes=n_pass, frame_s=[d - h for d, h in zip(done, hand)],
        host_s=host_s, traced=traced, poses=poses_buf[:k], tracked=tracked_buf[:k],
        state=state, tracer=tracer, counts=counts,
        pass_s=[b - a for a, b in zip([t0] + pass_end[:-1], pass_end)],
    )


def check(prog: Program, inputs, win, seed: int, scale: float, max_replays: int = 2):
    """The numbers that decide ``correct``: the last pass against the
    reference, and every other pass's poses against the last pass's (a
    pass that differs is replayed by the reference as well, up to
    ``max_replays`` of them drawn from the seed). Returns (numbers,
    passes replayed, passes identical to the last)."""
    dev = prog.device
    n = inputs.frames_mm.shape[0]
    frames = torch.stack([to_metres(inputs.frames_mm[j], dev, scale) for j in range(n)])
    init = torch.as_tensor(inputs.poses[0], dtype=torch.float32, device=dev)
    last = slice((win.passes - 1) * n, win.passes * n)
    st = win.state
    got = ref_orbit.PassOut(win.poses[last], win.tracked[last], st.volume.data, st.planes,
                            st.model_maps)
    want = ref_orbit.replay(frames, got, init, prog.config)
    nums = ref_orbit.numbers(got, want)
    del want
    differing = []
    for p in range(win.passes - 1):
        sl = slice(p * n, (p + 1) * n)
        same = torch.equal(win.poses[sl], win.poses[last]) and torch.equal(win.tracked[sl],
                                                                           win.tracked[last])
        if not same:
            differing.append(p)
    random.Random(seed).shuffle(differing)
    for p in differing[:max_replays]:
        sl = slice(p * n, (p + 1) * n)
        other = ref_orbit.PassOut(win.poses[sl], win.tracked[sl])
        w2 = ref_orbit.replay(frames, other, init, prog.config, want_end=False)
        for key, val in ref_orbit.numbers(other, w2).items():
            nums[key] = max(nums[key], val)
    if len(differing) > max_replays:
        # passes left unreplayed: their poses are held to the last pass's
        g = win.poses.reshape(win.passes, n, 4, 4)
        gap = (g[differing][:, 1:, 3, :3] - win.poses[last][None, 1:, 3, :3]).norm(dim=-1).max()
        nums["pose_gap_mm"] = max(nums["pose_gap_mm"], float(gap) * 1e3)
    return nums, 1 + min(len(differing), max_replays), win.passes - 1 - len(differing)


def run(cell, seed: int, seconds: float, trace: bool, t_start: float, volume_dtype=None,
        device="cuda"):
    """Set-up, window, reading and check of one run of an orbit cell
    (``volume_dtype`` overrides the configuration's volume type: the
    control; ``device`` the card, or the CPU in the CPU tests)."""
    dev = torch.device(device)
    config, traffic = cell.config, cell.traffic
    scale = float(config["camera"]["depth_scale"])
    dtype = {"float32": torch.float32, "bfloat16": torch.bfloat16}[
        volume_dtype or config["volume"]["dtype"]]
    prog = Program(config, dev, dtype)
    inputs = make_inputs(config, traffic, seed, dev)
    warm(prog, inputs, scale)
    if trace:  # the profiler's own start-up, outside the window
        warm_tracer = Tracer(dev)
        warm_tracer.start()
        with warm_tracer.span("warm"):
            torch.zeros(1, device=dev).add_(1)
        warm_tracer.stop()
    gc.collect()
    gc.freeze()  # set-up's objects stay out of the window's collections
    setup_s = time.time() - t_start
    win = run_window(prog, inputs, seconds, scale, trace)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    attempted = win.frames
    failed = int((~win.tracked).sum())
    t_check = time.perf_counter()
    nums, replayed, identical = check(prog, inputs, win, seed, scale)
    check_s = time.perf_counter() - t_check
    return SimpleNamespace(
        setup_s=setup_s, window=win, memory_peak_bytes=peak, attempted=attempted,
        failed=failed, numbers=nums, inputs=inputs, config=config, traffic=traffic,
        notes=dict(passes=win.passes, passes_replayed=replayed, passes_identical=identical,
                   window_s=win.seconds, check_s=check_s,
                   pass_host_s=[round(x, 4) for x in win.pass_s]),
    )
