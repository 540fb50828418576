#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port on one NVIDIA GPU and check it.

Run from the repository root with one CUDA device visible:

    python3 chip_smoke.py

It uses ``housescan_tpu_torch`` only (no JAX) and runs the workload of the
reference bench (phase 14: also its curved and noisy worlds; phase 15:
the whole cycle from depth frames to placed rooms): the synthetic furnished room, a 21-pose orbit
(``orbit_poses(21, radius=0.25, yaw_range=0.4, pitch=0.25)``) and 640x480
depth, on three paths: the kernel path on a 512^3 volume over 3 m in both
layouts (int16-packed int32, and the float32 (2, X, Y, Z) array, the
reference's default), the XLA path (``use_pallas=False``) on a 480^3
float32 volume over 3 m, a resolution that does not tile into 128-voxel
chunks, and the dense path (K8 then ``raycast_pallas``) on a 512^3
float32 volume. Phases, each fatal on failure:

  1. a CUDA device must be present;
  2. print the card's name and power limit (nvidia-smi);
  3. build the kernel library from ``housescan_tpu_torch/csrc`` (one nvcc
     per source, in parallel) and print the build time and the ptxas
     register/spill lines;
  4. box-512 (packed): run the fusion orbit once (warm), then compare each
     kernel (K1 bilateral, K3 ICP level, K4 stream integrate, K5 free
     carve, K6 plane raycast) with its plain PyTorch version on the card
     at the shapes the main path gives it; K5 on a free list of at least
     16 superblocks (the state after frame 20, else after frame 0), then
     timed on that list with its count set to 0 (an empty list, which
     must change nothing); K6 bit-identical on all 9 rows at 640x480 and,
     on the same planes, at 160x120 (384 candidates a tile), with each
     size's candidates a tile (mean, max, tiles with none, full tiles);
     then K3's three level calls of a step, each run twice (bit-identical
     required), held against its plain version (phase 4's bounds) and
     timed (CUDA events, and its device kernels by the profiler), K4
     over the main list's every row with the count set to 0 (an empty
     list) and with its real count, and K7 on the warm state's packed
     volume (bit-identical; its device time and its bound counted from
     the volume's observed voxels, as in phase 11);
  5. integrate the orbit at its poses with and without the free split:
     the volumes and planes must be bit-identical;
  6. run the fusion orbit again from a fresh state, timed on the host
     clock (frames 1..20 after frame 0, ending in a synchronize), gate the
     final pose error at the reference bench's 5 mm budget, and require
     every kernel of the path to have launched in it and no plain version
     to have run; one more step must make the host wait on the card
     nowhere (PyTorch's sync debug mode);
  7. box-512-f32: phases 4-6 on the float32 volume: a warm pass, K4 and K5
     against their plain versions on the float layout, split against
     unsplit bit-identical, K7 as the oracle of K4's persistent planes
     (a fresh extraction after a step equals them on every listed chunk:
     valid flags identical, fields but 11 within 1e-5 where valid), K4 and
     K5 on the empty list, then the timed pass with phase 6's gates;
  8. the scan at full width: record the 21 frames, load them, and run
     ``scan_to_room_dir(config=Config(), write_mesh=True)`` (the kernel
     path, fusing into float32) into ``build/chip_smoke/scan_room``; the
     kernel launch counts of this run must show every kernel of the kernel
     path and no plain version; gate on no dropped frame, every
     reference-layout file present and parsing, >= 2 planes and a
     non-empty mesh inside the volume; print the pose error and the host
     time of each phase (fusion, surface points, RANSAC, marching
     tetrahedra, writes), then RANSAC once more on the same cloud, split
     into the detection on the card and the host's hulls;
  9. xla-480: the orbit on the XLA path, a warm pass over frames 0-2,
     then a timed pass with launch counts: pose error <= 5 mm, 20/20
     tracked, model-map coverage >= 0.5, K1 and K2 launched, K3-K8 not, no
     plain version; print ms/frame, fps and peak memory; then K2 (the
     standalone solve) against its plain version on the card on the
     (A, b, pose) of real iterations of that orbit's last frame and on
     degenerate systems (bit-identical), its device time a call beside an
     empty one-thread kernel's (the latency floor), and one more step
     that must not make the host wait on the card;
 10. scan-480: ``scan_to_room_dir`` at ``Config()`` with a 480^3 volume,
     which takes the XLA path unasked, into
     ``build/chip_smoke/scan_room_480``, with phase 8's gates and launch
     counts showing K1 and K2 and no plain version;
 11. dense-512: K8 (``tsdf_integrate_with_planes``) fuses the 21 frames at
     their true poses into a fresh float32 volume, then ``raycast_pallas``
     (K7, K6) renders the last and the first pose; K8, K7 and K6 launched,
     no other kernel and no plain version; the reference's depth-quality
     gates at each pose (coverage > 0.55, median |depth - true depth| <
     0.5 mm on jointly valid pixels, > 10 mm on fewer than 4%); then K7
     against its plain version on the fused volume (bit-identical; its
     observed voxels and 32-byte z-segments, its device time by launch
     and its bound counted from the data: every weight, the tsdf of the
     observed voxels, the planes, beside the loose one of earlier
     readings) and the render's time (one ``raycast_pallas`` call), K8
     against its plain version (frame 1 on a volume carried
     from frame 0: bit-identical on classes, weights, tsdf and planes;
     its chunk classes, its time by CUDA events, its device time by
     launch by the profiler and its bandwidth against the bound
     printed), and K8 against K4 from fresh volumes: the twin of
     the reference's test (128^3, 160x120: weights agree on >= 99.9% of
     voxels, the tsdf's 99th percentile |diff| < 1e-5 on jointly observed
     ones) and the orbit's frame 0 at full width (p99 < 1e-4, derived in
     ``run_dense``);
 12. time each kernel and its plain version with CUDA events, beside its
     bound: max(bytes / 3.35 TB/s, float ops / 67 TFLOP/s) for this run's
     inputs (H100 SXM data sheet; each input byte read once, each output
     byte written once); K4 and K5 on both layouts, K6 at 160x120 too;
     K1's device time and an estimate of its instruction-issue floor
     (its static SASS count for each warp at 4 a clock an SM, cuobjdump); each
     kernel's resident blocks an SM (the occupancy calculator);
 13. profile three fusion steps of the kernel path (both layouts) and one
     of the XLA path: device kernel time per step against the timed pass's frame
     time (the device's busy share) and beside the readings before K5's
     and K6's redesign, the launches per step, each stage's device and
     host time a step, the top kernels, and the full tables in
     ``build/chip_smoke/profile.txt``, ``profile_f32.txt`` and
     ``profile_xla.txt``;
 14. curved-512 and noisy-512: the bench orbit on the kernel path at
     box-512's setup in the curved world (spheres, a capped cylinder,
     yaw-rotated boxes), and in the box world with 2 mm depth noise
     (seed 0) rounded through uint16 millimetres; each from a fresh
     packed volume with the counts set to 0: every kernel of the path
     launched, no plain version, no frame dropped, the pose error within
     bench.py's budget (12.5 and 11.0 mm), no host synchronisation in one
     more step; its fps, device time a step, and K1, K3, K4, K5 and K6
     against their plain versions on its last frame with phase 4's
     bounds;
 15. rooms: two rooms scanned by ``scan_to_room_dir`` at ``Config()``
     (512^3 float32, 640x480, 32 known poses each, as
     tests/test_end_to_end.py sweeps them) into ``build/chip_smoke/rooms``,
     then the room stage with every scene on the card: load, corners,
     cuboid fit, a room moved, walls connected, positions optimised,
     .xf files and placed full-resolution clouds, with that test's
     assertions and the host seconds of each phase; then the same on the
     CPU from the same directories, the card held to it (corners 1e-4 m,
     rmse 1e-5, positions 1e-4 m, .xf 1e-5).

``python3 chip_smoke.py --probe`` runs phases 1-4, phase 7's K4 and K5
comparisons and empty lists, phase 12's times of the main path's kernels
(K1, K3-K6) and of K7 on box-512's packed volume, with K1's device time
and estimated issue floor, K8 on dense-512's compare input and K7 on the
orbit fused by K8 (phase 11's comparisons and readings, the render's
time, phase 12's times), every kernel's resident blocks an SM, phase 13's profile of the
kernel path on both layouts, then K2 on the systems of box-512's warm
state (phase 9's comparison and readings, timed), and prints no result
line. It calls nothing that the package of the commit before K7's and
K2's redesign lacks, so copied into a checkout of that commit it reads
the same calls there: the before and after of a redesign, in turns
within one run on the card.

Numbers are printed beside the card's name and power limit. The line
before the last is the kernels' JSON record (launches: each kernel's
path's run: the scan's for the kernel path, the timed xla-480 pass for
K2, the dense-512 run for K7 and K8); the last line is ``{"ok": true,
"device": {...}}``.
"""

import bisect
import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np
import torch

RES = 512
XLA_RES = 480  # does not tile into 128-voxel chunks: the XLA path
N_FRAMES = 20
POSE_BUDGET_MM = 0.15 * N_FRAMES + 2.0  # bench.py's gate, 5 mm at 20 frames
OUT = "build/chip_smoke"
KERNELS = {
    "bilateral": ("housescan_tpu_torch/csrc/bilateral.cu", "housescan_tpu/ops/preprocess_pallas.py:26"),
    "icp_level": ("housescan_tpu_torch/csrc/icp.cu", "housescan_tpu/ops/icp_pallas.py:51"),
    "tsdf_stream": ("housescan_tpu_torch/csrc/tsdf_stream.cu", "housescan_tpu/ops/tsdf_stream.py:105"),
    "tsdf_free": ("housescan_tpu_torch/csrc/tsdf_free.cu", "housescan_tpu/ops/tsdf_stream.py:814"),
    "raycast_tiles": ("housescan_tpu_torch/csrc/raycast_tiles.cu", "housescan_tpu/ops/raycast_tiles.py:337"),
    "solve6": ("housescan_tpu_torch/csrc/solve6.cu", "housescan_tpu/ops/solve6_pallas.py:174"),
    "planes_extract": ("housescan_tpu_torch/csrc/planes_extract.cu",
                       "housescan_tpu/ops/planes_pallas.py:372"),
    "tsdf_dense": ("housescan_tpu_torch/csrc/tsdf_dense.cu", "housescan_tpu/ops/tsdf_pallas.py:53"),
}
HBM_BYTES_PER_S = 3.35e12  # H100 SXM
F32_OPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores
QUEUE_CYCLES = 50_000_000  # ~25 ms of device clock: cuda_ms's head start for the host
CHUNK_VOXELS = 8 * 8 * 128
TILE_BYTES = 16 * 16 * 4  # one chunk's planes tile
LAYOUTS = {torch.int32: "packed", torch.float32: "float32"}
SMALL_CAM = (160, 120, 131.25, 131.25, 79.5, 59.5)  # the reference tests' 160x120 camera
SMALL_K6 = "raycast_tiles@160x120"  # K6 at SMALL_CAM: 30 tiles, 384 candidates a tile
PACKED_K7 = f"planes_extract@box-{RES}"  # K7 on box-512's packed volume after its warm orbit


def chunk_bytes(data) -> int:
    """Bytes of one (8, 8, 128) chunk of the volume's layout: 4 a voxel
    packed, 8 float32."""
    return CHUNK_VOXELS * (4 if data.dim() == 3 else 8)


def mark(phase: int, t_start: float) -> None:
    """Print the host seconds since the start when ``phase`` ends."""
    print(f"# phase {phase} done at {time.perf_counter() - t_start:.1f} s", flush=True)


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds per call by CUDA events, after one warm call. A
    device-side wait of QUEUE_CYCLES first lets the host queue the calls
    ahead of the device, so a call whose host work is shorter than its
    kernel is timed by the device's work alone (a call that waits on the
    device, as the plain versions do, is timed as before)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(QUEUE_CYCLES)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound(n_bytes: float, n_ops: float):
    """(bound ms, what bounds it): the least time the card could take."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def workload(device):
    from housescan_tpu_torch.kinfu.camera import Intrinsics
    from housescan_tpu_torch.kinfu.synthetic import furnished_room, orbit_poses, render_depth_stream

    intr = Intrinsics(640, 480, 525.0, 525.0, 319.5, 239.5)
    poses = orbit_poses(N_FRAMES + 1, radius=0.25, yaw_range=0.02 * N_FRAMES, pitch=0.25)
    half, boxes = furnished_room()
    frames = render_depth_stream(intr, poses, half, boxes, device=device)
    return intr, poses, frames


def run_orbit(intr, poses, frames, res, device, dtype=torch.int32, use_pallas=True):
    """Fresh state, frame 0, then frames 1..N; returns (state, seconds
    for frames 1..N on the host clock, per-frame tracked flags)."""
    from housescan_tpu_torch.kinfu.pipeline import kinfu_init, kinfu_step

    st = kinfu_init(intr, resolution=res, size_m=3.0, trunc=0.03, init_pose=poses[0], dtype=dtype,
                    device=device)
    st = kinfu_step(st, frames[0], intr, use_pallas=use_pallas)
    torch.cuda.synchronize()
    tracked = []
    t0 = time.perf_counter()
    for i in range(1, len(frames)):
        st = kinfu_step(st, frames[i], intr, use_pallas=use_pallas)
        tracked.append(st.last_tracked)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    return st, seconds, [bool(t) for t in tracked]


def free_inputs(vol, planes, depth, pose, intr):
    """The free work list, the K4 main list and the kernel parameters of
    one integrate, and the number of listed superblocks and members."""
    from housescan_tpu_torch.ops.chunk_select import build_worklist, decode_free_worklist
    from housescan_tpu_torch.ops.tsdf_stream import FIELD_SAT, N_QUARTERS, _stream_params

    sat = planes[:, :, :, FIELD_SAT, :N_QUARTERS].reshape(-1, N_QUARTERS) > 0.5
    neg = planes[:, :, :, FIELD_SAT, N_QUARTERS].reshape(-1) > 0.5
    wl, fwl = build_worklist(depth, pose, intr, vol.dims, vol.voxel_size, vol.origin, vol.trunc,
                             sat_quarters=sat, neg_flags=neg, free_split=True)
    params = _stream_params(vol, pose, intr, 128.0, vol.dims[0] // 8, vol.dims[2] // 128)
    entries, members = decode_free_worklist(fwl)
    n_sb = sum(1 for e in entries if e[0])
    return wl, fwl, params, n_sb, len(members)


def compare_kernels(st, st0, intr, depth, depth1, pose1, card):
    """Each kernel against its plain version at the main path's shapes,
    from the state after the warm orbit (K5: that state, else the state
    after frame 0 with frame 1). Returns per-kernel max abs error, the
    callables the timing phase reuses and each kernel's bound inputs."""
    from housescan_tpu_torch.kinfu import maps as mp
    from housescan_tpu_torch.kinfu.camera import Intrinsics
    from housescan_tpu_torch.kinfu.preprocess import build_pyramid
    from housescan_tpu_torch.ops.icp_cuda import BAND_H, icp_level, icp_level_plain
    from housescan_tpu_torch.ops.preprocess_cuda import bilateral_filter_cuda, bilateral_filter_plain

    errs, calls, bounds = {}, {}, {}
    h, w = intr.height, intr.width

    # K1: 9 float ops per tap (49 taps at radius 3), one read and one write a pixel
    k = bilateral_filter_cuda(depth)
    q = bilateral_filter_plain(depth)
    errs["bilateral"] = float((k - q).abs().max())
    if not torch.equal(k, q):
        fail(f"K1 bilateral differs from its plain version by {errs['bilateral']} (0 required)")
    calls["bilateral"] = (lambda: bilateral_filter_cuda(depth), lambda: bilateral_filter_plain(depth))
    bounds["bilateral"] = bound(2 * h * w * 4, 9 * 49 * h * w)

    # K3 at the finest level, with the step's level-0 arguments: the packed
    # maps read once; ~120 float ops a pixel and iteration (association,
    # residual, Jacobian, the 27 normal-equation sums)
    pyr = build_pyramid(depth, intr)
    packed = mp.pack_icp_inputs(pyr.maps[0], st.model_maps, mp.model_gradients(st.model_maps), band_h=BAND_H)
    tight = torch.clamp(0.5 * st.volume.voxel_size, min=0.006)
    args = dict(n_iters=10, window=0, dist_threshold=tight, damping=3e-4, tight_threshold=tight)
    kp, kr, kc = icp_level(packed, st.model_pose, st.model_pose, intr, **args)
    qp, qr, qc = icp_level_plain(packed, st.model_pose, st.model_pose, intr, **args)
    errs["icp_level"] = float((kp - qp).abs().max())
    if errs["icp_level"] > 5e-5 or abs(float(kr) - float(qr)) > 1e-4 or \
            abs(int(kc) - int(qc)) > max(5, int(qc) // 200):
        fail(f"K3 icp_level differs: pose {errs['icp_level']}, rmse {float(kr)} vs {float(qr)}, "
             f"corr {int(kc)} vs {int(qc)}")
    if int(kc) < 1000:
        fail(f"K3 comparison ran on too few correspondences ({int(kc)})")
    calls["icp_level"] = (
        lambda: icp_level(packed, st.model_pose, st.model_pose, intr, **args),
        lambda: icp_level_plain(packed, st.model_pose, st.model_pose, intr, **args),
    )
    bounds["icp_level"] = bound(packed.numel() * 4, 120 * 10 * packed.shape[1] * packed.shape[2])

    errs["tsdf_stream"], calls["tsdf_stream"], bounds["tsdf_stream"], n_listed = \
        compare_stream(st, depth, intr)
    errs["tsdf_free"], calls["tsdf_free"], bounds["tsdf_free"], n_sb, n_members = \
        compare_free(st, st0, depth, depth1, pose1, intr, card)

    # K6 at the main path's 640x480 (96 candidates a tile) and, on the same
    # planes, at 160x120 (fewer than 128 tiles: 384 a tile)
    for cam, key in ((intr, "raycast_tiles"), (Intrinsics(*SMALL_CAM), SMALL_K6)):
        errs[key], calls[key], bounds[key] = compare_raycast(st, cam, card)
    return errs, calls, bounds, dict(n_listed=n_listed, n_sb=n_sb, n_members=n_members)


def compare_raycast(st, cam, card):
    """K6 against its plain version on the state's planes at its pose, at
    camera ``cam``: every one of the 9 rows bit-identical (the kernel runs
    the plain version's float32 operations; the nearest hit, ties to the
    larger block id, and the nearest occluder do not depend on the order
    of a tile's candidates, whose block ids are unique). Prints the
    per-tile candidate counts. Returns (0.0, timing calls, bound). Bound:
    the candidates read once and the 9 output rows written once; ~17
    float ops per pixel and usable candidate of its tile."""
    from housescan_tpu_torch.ops.raycast_tiles import (
        _ray_params, build_tile_candidates, launch_raycast_kernel, raycast_tiles_plain,
    )

    cand = build_tile_candidates(st.planes, st.pose, cam, st.volume)
    n_ut = -(-cam.width // 128)
    w_pad = n_ut * 128
    rparams = _ray_params(st.pose, cam, 0.3, n_ut)
    k = launch_raycast_kernel(cand, rparams, cam.height, w_pad)
    q = raycast_tiles_plain(cand, rparams, cam.height, w_pad)
    torch.cuda.synchronize()
    counts = (cand[:, :, 9] > 0.5).sum(dim=1)
    n_tiles, max_ct = cand.shape[0], cand.shape[1]
    kval, qval = k[0] > 0, q[0] > 0
    n_valid = int(qval.sum())
    where = f"{cam.width}x{cam.height}, {n_tiles} tiles of {max_ct} slots"
    print(f"# K6 candidates a tile ({where}): mean {float(counts.float().mean()):.2f}, max "
          f"{int(counts.max())}, {int((counts == 0).sum())} tiles with none, "
          f"{int((counts == max_ct).sum())} full, {int(counts.sum())} in all; {n_valid} pixels hit "
          f"[{card}]", flush=True)
    if not torch.equal(k, q):
        diff = float((k - q).abs().nan_to_num(float("inf")).max())
        fail(f"K6 ({where}) differs from its plain version: validity differs on "
             f"{int((kval != qval).sum())} pixels, max diff {diff}")
    if n_valid < cam.width * cam.height // 30:
        fail(f"K6 ({where}) comparison hit only {n_valid} pixels")
    print(f"# K6 compare ({where}): all 9 rows bit-identical", flush=True)
    calls = (lambda: launch_raycast_kernel(cand, rparams, cam.height, w_pad),
             lambda: raycast_tiles_plain(cand, rparams, cam.height, w_pad))
    return 0.0, calls, bound(cand.numel() * 4 + k.numel() * 4, 17 * 1024 * int(counts.sum()))


ICP_ITERS = (10, 5, 4)  # the step's iterations a level, finest first


def device_us(prof, reps):
    """{device kernel: (microseconds, launches) a call} of a profile over
    ``reps`` calls (memory copies left out; a memset counts: it is part of
    its wrapper's cost)."""
    avgs = prof.key_averages()
    attr = "self_device_time_total" if hasattr(avgs[0], "self_device_time_total") else "self_cuda_time_total"
    cuda = torch.autograd.DeviceType.CUDA
    return {e.key: (getattr(e, attr) / reps, e.count / reps) for e in avgs
            if e.device_type == cuda and not e.key.startswith("Memcpy")}


def icp_level_inputs(st, depth, intr):
    """The step's three K3 calls on ``depth`` against the state's model
    maps, coarsest first, each level starting from the pose the one
    before it reached, as ``icp_track`` chains them: [(level, packed
    maps, start pose, keyword arguments)]."""
    from housescan_tpu_torch.kinfu import icp
    from housescan_tpu_torch.kinfu import maps as mp
    from housescan_tpu_torch.kinfu.preprocess import build_pyramid
    from housescan_tpu_torch.ops.icp_cuda import BAND_H, icp_level

    pyr = build_pyramid(depth, intr)
    model_pyr = mp.build_map_pyramid(st.model_maps, 3)
    tight = torch.clamp(0.5 * st.volume.voxel_size, min=0.006)
    dists = (tight, 0.05, 0.10)
    pose, out = st.model_pose, []
    for level in (2, 1, 0):
        packed = mp.pack_icp_inputs(pyr.maps[level], model_pyr[level],
                                    mp.model_gradients(model_pyr[level]), band_h=BAND_H)
        kw = dict(n_iters=ICP_ITERS[level], window=icp.WINDOWS[level], dist_threshold=dists[level],
                  damping=icp.DAMPINGS[level], tight_threshold=tight)
        out.append((level, packed, pose, kw))
        pose = icp_level(packed, pose, st.model_pose, intr.level(level), **kw)[0]
    return out


def icp_levels(st, depth, intr, card, reps=20):
    """K3's three level calls of one step: each twice on the same inputs,
    which must agree bit for bit, and against its plain version at phase
    4's bounds (pose 5e-5, rmse 1e-4, correspondences max(5, n/200)); each
    call's time by CUDA events and its device kernels' time by the
    profiler. Returns {level: (ms a call, K3 kernels' device us a call,
    launches of K3 kernels a call)}."""
    from torch.profiler import ProfilerActivity, profile

    from housescan_tpu_torch.ops.icp_cuda import icp_level, icp_level_plain

    out = {}
    for level, packed, pose, kw in icp_level_inputs(st, depth, intr):
        cam = intr.level(level)

        def call():
            return icp_level(packed, pose, st.model_pose, cam, **kw)

        first, second = call(), call()
        qp, qr, qc = icp_level_plain(packed, pose, st.model_pose, cam, **kw)
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(first, second)):
            fail(f"K3 at level {level} differs between two runs on the same inputs")
        kp, kr, kc = first
        err = float((kp - qp).abs().max())
        if err > 5e-5 or abs(float(kr) - float(qr)) > 1e-4 or \
                abs(int(kc) - int(qc)) > max(5, int(qc) // 200):
            fail(f"K3 at level {level} differs from its plain version: pose {err}, rmse "
                 f"{float(kr)} vs {float(qr)}, corr {int(kc)} vs {int(qc)}")
        print(f"# K3 level {level} against its plain version: pose max abs err {err}, rmse "
              f"{float(kr)} vs {float(qr)}, corr {int(kc)} vs {int(qc)}", flush=True)
        ms = cuda_ms(call, reps)
        torch.cuda._sleep(QUEUE_CYCLES)
        t0 = time.perf_counter()
        for _ in range(reps):
            call()
        host_us = (time.perf_counter() - t0) / reps * 1e6
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                call()
            torch.cuda.synchronize()
        k3 = {k.split("(")[0]: v for k, v in device_us(prof, reps).items()
              if "icp_" in k.split("(")[0]}
        us, n_k3 = sum(v[0] for v in k3.values()), sum(v[1] for v in k3.values())
        out[level] = (ms, us, n_k3)
        print(f"# K3 level {level} {tuple(packed.shape)}, {kw['n_iters']} iterations: {ms:.4f} ms a "
              f"call (CUDA events), device {' + '.join(f'{k} {v[0]:.2f}' for k, v in k3.items())} "
              f"us a call in {n_k3:.0f} launches, the wrapper's host work {host_us:.1f} us a call; "
              f"two runs bit-identical [{card}]", flush=True)
    ms_step = sum(v[0] for v in out.values())
    print(f"# K3 a step (levels 2, 1, 0): {ms_step:.4f} ms by CUDA events, device "
          f"{sum(v[1] for v in out.values()) / 1000:.4f} ms in "
          f"{sum(v[2] for v in out.values()):.0f} launches [{card}]", flush=True)
    return out


def stream_empty_list(st, depth, intr, card, reps=20):
    """K4 over the main list's every row (one per chunk of the volume) with
    the count set to 0, which is the cost of a launch over an empty list,
    and with the real count. Returns (ms empty, ms listed)."""
    from housescan_tpu_torch.ops.tsdf_stream import build_depth_mips, launch_stream_kernel

    wl, _, params, _, _ = free_inputs(st.volume, st.planes, depth, st.pose, intr)
    mips = build_depth_mips(depth)
    data, planes = st.volume.data.clone(), st.planes.clone()
    zero = torch.zeros_like(wl.count)
    ms0 = cuda_ms(lambda: launch_stream_kernel(data, planes, wl.desc, zero, mips, params), reps)
    ms1 = cuda_ms(lambda: launch_stream_kernel(data, planes, wl.desc, wl.count, mips, params), reps)
    print(f"# K4 ({LAYOUTS[data.dtype]}) over {wl.desc.shape[0]} rows: count 0 {ms0:.4f} ms, count "
          f"{int(wl.count[0])} {ms1:.4f} ms (CUDA events) [{card}]", flush=True)
    return ms0, ms1


def sass_instructions(symbol_part: str):
    """SASS instructions of the first kernel of the built library whose
    mangled name holds ``symbol_part`` (cuobjdump), or None where
    cuobjdump is missing."""
    from housescan_tpu_torch.ops import cuda_lib

    tool = os.path.join(os.path.dirname(cuda_lib._nvcc()), "cuobjdump")
    if not os.path.exists(tool):
        return None
    out = subprocess.run([tool, "-sass", cuda_lib.build_info["path"]], capture_output=True,
                         text=True, timeout=120).stdout
    n, inside = 0, False
    for ln in out.splitlines():
        if "Function :" in ln:
            if inside:
                break
            inside = symbol_part in ln
        elif inside and ln.strip().startswith("/*") and "*/" in ln and ";" in ln:
            n += 1
    return n or None


def k1_readings(intr, calls, card):
    """K1 at the main path's shape: its device time by launch (profiler)
    and an estimate of its instruction-issue floor from the static SASS
    count: the kernel's SASS instructions (it is unrolled: each thread runs
    them about once; the staging loop is counted once and branches that do
    not run are counted too) for each of its warps, at 4 warp instructions
    a clock on each SM at the card's maximum SM clock."""
    k1 = kernel_device_us(calls["bilateral"][0], REPS["bilateral"][0])
    # the radius-3 instance; a K1 built before the radius template reads not measured
    n_sass = sass_instructions("bilateral_kernelILi3E")
    warps = -(-intr.width // 128) * -(-intr.height // 4) * 4
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    mhz = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, timeout=60).stdout.split()
    floor = "not measured"
    if n_sass and mhz:
        floor = (f"{warps * n_sass / (4 * sms * float(mhz[0]) * 1e6) * 1e3:.4f} ms ({n_sass} SASS "
                 f"instructions a thread, {warps} warps, {sms} SMs at {mhz[0]} MHz)")
    print(f"# K1 {intr.width}x{intr.height} device by launch: "
          f"{', '.join(f'{k[:60]} {v[0]:.2f} us x{v[1]:.0f}' for k, v in k1.items())}; "
          f"instruction-issue floor (estimate, static SASS count) {floor} [{card}]", flush=True)


def occupancy_report(intr, card):
    """Each kernel's resident blocks an SM at its main-path launch (K3 at
    the finest level's plan)."""
    from housescan_tpu_torch.ops import cuda_lib
    from housescan_tpu_torch.ops.icp_cuda import _plan
    from housescan_tpu_torch.ops.raycast_tiles import _max_ct

    n_tiles = -(-intr.height // 8) * -(-intr.width // 128)
    args = {"raycast_tiles": _max_ct(n_tiles),
            "icp_level": _plan(-(-intr.height // 32) * 32, -(-intr.width // 128) * 128,
                               torch.cuda.current_device()).shared_pixels}
    occ = {name: cuda_lib.occupancy(name, args.get(name, 0)) for name in cuda_lib.OCCUPANCY}
    print(f"# resident blocks an SM: {json.dumps(occ)} [{card}]", flush=True)
    return occ


def _tw(data):
    """(tsdf, weight) of either layout as float32 tensors."""
    if data.dim() == 3:
        return (data >> 16).to(torch.float32) / 32767.0, (data & 0xFFFF).to(torch.float32)
    return data[0], data[1]


def compare_stream(st, depth, intr):
    """K4 against its plain version on copies of the state's volume (either
    layout), on the main list left by the split: weights identical, the
    packed tsdf within one step on >= 99.9% of voxels (float32: 1e-6),
    plane valid flags on >= 99.9% of sub-blocks, fields 1e-5 where both
    are valid, field 11 identical. Returns (max abs tsdf error, timing
    calls, bound, listed chunks). Bound: each listed chunk read and
    written once plus its planes tile, the mips read once; ~60 float ops
    a voxel."""
    from housescan_tpu_torch.ops.tsdf_stream import (
        FIELD_SAT, build_depth_mips, integrate_plain, launch_stream_kernel,
    )

    vol, planes, pose = st.volume, st.planes, st.pose
    res = vol.dims[0]
    tag = LAYOUTS[vol.data.dtype]
    wl, _, params, _, _ = free_inputs(vol, planes, depth, pose, intr)
    mips = build_depth_mips(depth)
    kd, kpl = vol.data.clone(), planes.clone()
    launch_stream_kernel(kd, kpl, wl.desc, wl.count, mips, params)
    qd, qpl = vol.data.clone(), planes.clone()
    integrate_plain(qd, qpl, wl.desc, wl.count, mips, params, res // 8, res // 128)
    torch.cuda.synchronize()
    n_listed = int(wl.count[0])
    (kt, kw), (qt, qw) = _tw(kd), _tw(qd)
    if not torch.equal(kw, qw):
        fail(f"K4 ({tag}) weights differ from the plain version")
    err = float((kt - qt).abs().max())
    close = (kt - qt).abs() <= (1.0 / 32767.0 if kd.dim() == 3 else 1e-6) * 1.0001
    if float(close.float().mean()) < 0.999:
        fail(f"K4 ({tag}) tsdf differs by more than its bound on > 0.1% of voxels")
    kv, qv = kpl[:, :, :, 4] > 0.5, qpl[:, :, :, 4] > 0.5
    if float((kv == qv).float().mean()) < 0.999:
        fail(f"K4 ({tag}) plane valid flags differ")
    both = (kv & qv)[:, :, :, None, :].expand_as(kpl)
    fdiff = float((kpl - qpl)[both].abs().max()) if bool(both.any()) else 0.0
    if fdiff > 1e-5 or not torch.equal(kpl[:, :, :, FIELD_SAT], qpl[:, :, :, FIELD_SAT]):
        fail(f"K4 ({tag}) plane fields differ by {fdiff}")
    print(f"# K4 compare ({tag}): {n_listed} listed chunks (main list after the split), "
          f"tsdf max abs err {err}, plane field max diff {fdiff}", flush=True)
    del kd, qd, kpl, qpl
    scratch = vol.data.clone(), planes.clone()
    calls = (
        lambda: launch_stream_kernel(scratch[0], scratch[1], wl.desc, wl.count, mips, params),
        lambda: integrate_plain(scratch[0], scratch[1], wl.desc, wl.count, mips, params,
                                res // 8, res // 128),
    )
    mip_bytes = sum(m.numel() for m in mips) * 4
    return err, calls, bound(n_listed * (2 * chunk_bytes(vol.data) + TILE_BYTES) + mip_bytes,
                             60 * CHUNK_VOXELS * n_listed), n_listed


def compare_free(st, st0, depth, depth1, pose1, intr, card):
    """K5 against its plain version on copies, on a free list of >= 16
    superblocks (the state after frame 20, else after frame 0 with frame
    1): bit-identical; then the same list with its count set to 0 (the
    cost of a launch over an empty list), which must leave the volume and
    planes untouched. Returns (0.0, timing calls, bound, listed
    superblocks, member chunks). Bound: each member
    chunk read once, the volume words the carve changes written once (a
    word that keeps its value need not be stored) and each member's planes
    tile written; ~30 float ops a voxel."""
    from housescan_tpu_torch.ops.tsdf_stream import free_carve_plain, launch_free_kernel

    vol, planes, pose = st.volume, st.planes, st.pose
    tag = LAYOUTS[vol.data.dtype]
    wl, fwl, params, n_sb, n_members = free_inputs(vol, planes, depth, pose, intr)
    src = "after frame 20"
    if n_sb < 16:
        vol, planes, pose = st0.volume, st0.planes, pose1
        wl, fwl, params, n_sb, n_members = free_inputs(vol, planes, depth1, pose, intr)
        src = "after frame 0, frame 1"
    if n_sb == 0:
        fail(f"K5 ({tag}) comparison: the free work list is empty")
    kd, kpl = vol.data.clone(), planes.clone()
    launch_free_kernel(kd, kpl, fwl, params)
    qd, qpl = vol.data.clone(), planes.clone()
    free_carve_plain(qd, qpl, fwl, params)
    torch.cuda.synchronize()
    changed = int((_tw(kd)[1] != _tw(vol.data)[1]).sum())
    # 4-byte words of the volume the carve changes (packed cells, or float32
    # tsdf and weight words), compared as bits
    words = int((kd.view(torch.int32) != vol.data.view(torch.int32)).sum())
    if not torch.equal(kd, qd) or not torch.equal(kpl, qpl):
        fail(f"K5 ({tag}) free carve differs from its plain version")
    print(f"# K5 compare ({tag}, {src}): {n_sb} listed superblocks, {n_members} member chunks, "
          f"{changed} voxel weights changed, {words} volume words changed, bit-identical",
          flush=True)
    if n_sb < 16:
        print(f"# K5 compare: only {n_sb} superblocks listed (fewer than 16)", flush=True)
    del kd, qd, kpl, qpl
    scratch = vol.data.clone(), planes.clone()
    empty = fwl._replace(count=torch.zeros_like(fwl.count))
    launch_free_kernel(scratch[0], scratch[1], empty, params)
    torch.cuda.synchronize()
    if not torch.equal(scratch[0], vol.data) or not torch.equal(scratch[1], planes):
        fail(f"K5 ({tag}) over an empty list changed the volume or the planes")
    ms0 = cuda_ms(lambda: launch_free_kernel(scratch[0], scratch[1], empty, params),
                  REPS["tsdf_free"][0])
    print(f"# K5 ({tag}) over {fwl.bitmap.shape[0]} entries: count 0 {ms0:.4f} ms (CUDA events), "
          f"volume and planes untouched [{card}]", flush=True)
    calls = (
        lambda: launch_free_kernel(scratch[0], scratch[1], fwl, params),
        lambda: free_carve_plain(scratch[0], scratch[1], fwl, params),
    )
    # the words that do not change need not be written: the least bytes are
    # every member chunk read, the changed words and the planes tiles written
    return 0.0, calls, bound(n_members * (chunk_bytes(vol.data) + TILE_BYTES) + 4 * words,
                             30 * CHUNK_VOXELS * n_members), n_sb, n_members


def split_orbit_identical(intr, poses, frames, device, dtype):
    """The orbit's frames integrated at its poses with and without the
    free split: final volumes and planes must be bit-identical."""
    from housescan_tpu_torch.kinfu.tsdf import tsdf_new
    from housescan_tpu_torch.ops.tsdf_stream import planes_shape, tsdf_integrate_stream

    out = []
    for split in (True, False):
        vol = tsdf_new(RES, 3.0, 0.03, dtype=dtype, device=device)
        planes = torch.zeros(planes_shape(RES), device=device)
        for d, p in zip(frames, poses):
            tsdf_integrate_stream(vol, planes, d, torch.from_numpy(p).to(device), intr,
                                  free_split=split)
        out.append((vol.data, planes))
    torch.cuda.synchronize()
    same = torch.equal(out[0][0], out[1][0]) and torch.equal(out[0][1], out[1][1])
    observed = int((_tw(out[0][0])[1] > 0).sum())
    return same, observed


def check_counts(what, launches, plain, path_kernels):
    """Fail unless every kernel of the path launched, no other kernel did
    and no plain version ran."""
    missing = [k for k in path_kernels if launches[k] <= 0]
    stray = [k for k in KERNELS if k not in path_kernels and launches[k]]
    ran_plain = [k for k in KERNELS if plain[k]]
    if missing or stray or ran_plain:
        fail(f"{what}: kernels not launched {missing}, launched off the path {stray}, "
             f"plain versions run {ran_plain}")


def run_scan(intr, poses, frames, card, res=RES):
    """scan_to_room_dir at the reference's default Config() (at ``res``)
    over the recorded orbit; every gate of phase 7. At 512^3 the scan
    takes the kernel path; at 480^3 the XLA path, unasked."""
    from dataclasses import replace

    from housescan_tpu_torch.capture.replay import load_stream, record_stream
    from housescan_tpu_torch.config import Config
    from housescan_tpu_torch.io.pcd import load_pcd
    from housescan_tpu_torch.io.planes_txt import load_planes_txt
    from housescan_tpu_torch.io.ply import load_ply
    from housescan_tpu_torch.kinfu import scan
    from housescan_tpu_torch.kinfu.pipeline import pallas_supported
    from housescan_tpu_torch.ops import cuda_lib

    room = os.path.join(OUT, "scan_room" if res == RES else f"scan_room_{res}")
    shutil.rmtree(room, ignore_errors=True)
    path = record_stream(os.path.join(OUT, "orbit_stream.npz"), frames, intr, poses=poses)
    stream = load_stream(path)
    cfg = Config()
    cfg = replace(cfg, tsdf=replace(cfg.tsdf, resolution=res))
    kernel_path = pallas_supported(res)
    timings = {}
    # the layout the scan fuses into, read from the state it creates
    init, layouts = scan.kinfu_init, []

    def recording_init(*args, **kwargs):
        state = init(*args, **kwargs)
        layouts.append((state.volume.data.dtype, tuple(state.volume.data.shape)))
        return state

    scan.kinfu_init = recording_init
    cuda_lib.reset_counts()
    t0 = time.perf_counter()
    try:
        scan.scan_to_room_dir(stream, room, config=cfg, init_pose=poses[0], write_mesh=True,
                              timings=timings)
    finally:
        scan.kinfu_init = init
    total = time.perf_counter() - t0
    if layouts != [(torch.float32, (2, res, res, res))]:
        fail(f"the scan at {res}^3 fused into {layouts}, not the float32 volume")
    launches, plain = dict(cuda_lib.launch_counts), dict(cuda_lib.plain_counts)
    tag = "kernel path" if kernel_path else "XLA path"
    print(f"# scan {res}^3 ({tag}) launches {json.dumps(launches)} plain {json.dumps(plain)}",
          flush=True)
    check_counts(f"the scan at {res}^3", launches, plain,
                 cuda_lib.KERNEL_PATH if kernel_path else cuda_lib.XLA_PATH)

    traj = np.load(os.path.join(room, "trajectory.npz"))["poses"]
    if traj.shape != (N_FRAMES + 1, 4, 4) or not np.isfinite(traj).all():
        fail(f"trajectory.npz malformed: {traj.shape}")
    # a dropped frame keeps the previous pose bit for bit
    dropped = int(sum(np.array_equal(traj[i], traj[i - 1]) for i in range(1, len(traj))))
    if dropped:
        fail(f"the scan dropped {dropped} frame(s)")
    err_mm = float(np.linalg.norm(traj[-1, 3, :3] - poses[N_FRAMES][3, :3])) * 1000.0
    full = load_pcd(os.path.join(room, "cloud_bin.pcd"))
    down = load_pcd(os.path.join(room, "cloud_downsampled.pcd"))
    planes = load_planes_txt(os.path.join(room, "planes.txt"))
    n_planes = planes.normal.shape[0]
    if n_planes < 2:
        fail(f"the scan found {n_planes} plane(s)")
    for k in range(n_planes):
        if len(load_pcd(os.path.join(room, f"cloud_plane_hull{k}.pcd"))) < 3:
            fail(f"hull {k} has fewer than 3 points")
    if len(full) < 10000 or len(down) != min(len(full), 1 << 16):
        fail(f"surface clouds malformed: {len(full)} / {len(down)} points")
    mesh = load_ply(os.path.join(room, "mesh.ply"))
    v = mesh.vertices
    if len(mesh.faces) == 0 or not np.isfinite(v).all() or (np.abs(v) >= 1.5).any():
        fail("mesh.ply empty or outside the volume")
    print(f"# scan {res}^3 {intr.width}x{intr.height} Config() ({tag}): {N_FRAMES + 1} frames, 0 dropped, "
          f"pose error {err_mm:.3f} mm (scalar 0.10 m ICP gate), {len(full)} surface points, "
          f"{n_planes} planes, {len(mesh.faces)} triangles [{card}]", flush=True)
    phases = " ".join(f"{k} {timings[k]:.4f} s" for k in
                      ("fusion", "surface_points", "ransac", "mesh", "writes"))
    print(f"# scan phases (host clock, each ending in a synchronize): {phases}; "
          f"total {total:.4f} s; fusion {timings['fusion'] / (N_FRAMES + 1) * 1000:.3f} ms/frame "
          f"[{card}]", flush=True)
    if not kernel_path:
        return launches

    # the RANSAC phase again on the same cloud, split into the detection
    # on the card (now warm) and the host's hulls
    from housescan_tpu_torch.kinfu.ransac import detect_planes, plane_hulls

    rc = cfg.ransac
    cloud = torch.from_numpy(down.points).to("cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    det = detect_planes(cloud, max_planes=rc.max_planes, n_hypotheses=rc.n_hypotheses,
                        inlier_threshold=rc.inlier_threshold,
                        min_inliers=max(int(rc.min_inlier_fraction * len(down)), 50))
    n_det = int(det.n_planes)
    t_det = time.perf_counter() - t0
    t0 = time.perf_counter()
    plane_hulls(down.points, det)
    t_hull = time.perf_counter() - t0
    print(f"# ransac again: detect_planes {t_det:.4f} s ({n_det} planes, warm), "
          f"plane_hulls {t_hull:.4f} s (host) [{card}]", flush=True)
    return launches


# The step's stages, as kinfu/pipeline.py calls them: each is wrapped in a
# profiler range while the profile runs, so the device time its kernels
# take and the host time it spends are read per stage.
STAGES = ("build_pyramid", "icp_track", "_integrate_dispatch", "raycast", "raycast_planes")


def profile_steps(intr, poses, frames, res, device, out_path, n=3, dtype=torch.int32,
                  use_pallas=True):
    """Device kernel time per step over ``n`` steps of a fresh orbit, the
    launches, the top kernels and each stage's (device ms, host ms) a
    step; the full table goes to ``out_path``."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from housescan_tpu_torch.kinfu import pipeline
    from housescan_tpu_torch.kinfu.pipeline import kinfu_init, kinfu_step

    st = kinfu_init(intr, resolution=res, size_m=3.0, trunc=0.03, init_pose=poses[0], dtype=dtype,
                    device=device)
    for i in range(3):
        st = kinfu_step(st, frames[i], intr, use_pallas=use_pallas)
    torch.cuda.synchronize()

    def ranged(name, fn):
        def wrapper(*args, **kwargs):
            with record_function(f"stage:{name}"):
                return fn(*args, **kwargs)
        return wrapper

    originals = {name: getattr(pipeline, name) for name in STAGES}
    try:
        for name, fn in originals.items():
            setattr(pipeline, name, ranged(name, fn))
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for i in range(3, 3 + n):
                st = kinfu_step(st, frames[i], intr, use_pallas=use_pallas)
            torch.cuda.synchronize()
    finally:
        for name, fn in originals.items():
            setattr(pipeline, name, fn)
    avgs = prof.key_averages()
    # named self_device_time_total in newer PyTorch, self_cuda_time_total before
    attr = "self_device_time_total" if hasattr(avgs[0], "self_device_time_total") else "self_cuda_time_total"
    cuda = torch.autograd.DeviceType.CUDA
    # the stage ranges also appear on the device timeline: not kernels
    kernels = [e for e in avgs if e.device_type == cuda and not e.key.startswith("stage:")]
    dev_ms = sum(getattr(e, attr) for e in kernels) / 1000.0 / n
    launches = sum(e.count for e in kernels) / n
    # a stage's device time: the kernels that start on the device timeline
    # between its range's start there and the next stage's (the profiler
    # attributes to a range only the kernels of PyTorch operators, not
    # those launched through ctypes; glue kernels after a stage count with
    # it); its host time: the range's wall time
    evs = [e for e in prof.events() if e.device_type == cuda]
    marks = sorted((e.time_range.start, e.key[len("stage:"):]) for e in evs
                   if e.key.startswith("stage:"))
    starts = [m[0] for m in marks]
    dev_us = {name: 0.0 for _, name in marks}
    for e in evs:
        i = bisect.bisect_right(starts, e.time_range.start) - 1
        if not e.key.startswith("stage:") and i >= 0:
            dev_us[marks[i][1]] += getattr(e, attr)
    stages = {e.key[len("stage:"):]: (dev_us.get(e.key[len("stage:"):], 0.0) / 1000.0 / n,
                                      e.cpu_time_total / 1000.0 / n)
              for e in avgs if e.key.startswith("stage:") and e.device_type != cuda}
    os.makedirs(os.path.dirname(out_path), exist_ok=True)
    with open(out_path, "w") as f:
        f.write(avgs.table(sort_by=attr, row_limit=60))
    top = sorted(kernels, key=lambda e: -getattr(e, attr))[:10]
    k2 = [e for e in kernels if "solve6_kernel" in e.key]
    k2_us = getattr(k2[0], attr) / k2[0].count if k2 else None
    return dev_ms, launches, [(e.key, getattr(e, attr) / 1000.0 / n, e.count / n) for e in top], \
        stages, k2_us


# Phase 13's profiles: (cell, profile_steps keywords, table file, the
# device ms and launches a step before K5's and K6's redesign, NVIDIA H100
# 80GB HBM3, 700.00 W).
PROFILES = (
    (f"box-{RES}", dict(res=RES), "profile.txt", (4.718, 2494)),
    (f"box-{RES}-f32", dict(res=RES, dtype=torch.float32), "profile_f32.txt", (4.795, 2494)),
    (f"xla-{XLA_RES}", dict(res=XLA_RES, dtype=torch.float32, use_pallas=False, n=1),
     "profile_xla.txt", (85.239, 16896)),
)


def report_profile(tag, intr, poses, frames, device, card, secs, kw, name, before):
    """Print profile_steps' reading of cell ``tag``: device time and
    launches a step beside ``before``, the device's busy share against the
    timed pass's ``secs`` (where given), each stage and the top kernels."""
    dev_ms, n_launch, top, stages, k2_us = profile_steps(intr, poses, frames, device=device,
                                                         out_path=os.path.join(OUT, name), **kw)
    busy = ""
    if secs is not None:
        frame_ms = secs / N_FRAMES * 1000.0
        busy = f"; timed pass {frame_ms:.3f} ms/frame -> device busy {dev_ms / frame_ms * 100:.1f}%"
    print(f"# profile {tag}: device kernel time {dev_ms:.3f} ms/step in {n_launch:.0f} "
          f"launches/step (before the redesign: {before[0]} ms in {before[1]}){busy} [{card}]",
          flush=True)
    for stage, (d_ms, h_ms) in stages.items():
        print(f"# profile {tag}: stage {stage}: device {d_ms:.3f} ms/step, host {h_ms:.3f} "
              f"ms/step", flush=True)
    if k2_us is not None:
        print(f"# profile {tag}: K2 solve6_kernel device time {k2_us:.2f} us a launch "
              f"[{card}]", flush=True)
    for key, ms, n in top:
        print(f"# profile {tag}: {ms:8.4f} ms/step {n:6.1f}x/step {key[:90]}", flush=True)
    torch.cuda.empty_cache()


def host_syncs(fn):
    """(fn's result, where it made the host wait on the card: the source
    lines, as PyTorch's sync debug mode reports them)."""
    import warnings

    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            out = fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    return out, [f"{os.path.relpath(w.filename)}:{w.lineno}" for w in caught
                 if "called a synchronizing" in str(w.message)]


def k2_systems(st, depth, intr):
    """(pose, A, b, damping) of real Gauss-Newton iterations: the XLA ICP
    loop of one frame against the state's model maps, every level at the
    adaptive gate's tight threshold, the pose advanced by K2's plain
    version; then the reference's degenerate systems (zero A, NaN A, NaN
    b), whose pose must come back unchanged."""
    from housescan_tpu_torch.kinfu import icp
    from housescan_tpu_torch.kinfu import maps as mp
    from housescan_tpu_torch.kinfu.preprocess import build_pyramid
    from housescan_tpu_torch.ops.solve6 import solve_twist_plain

    pyr = build_pyramid(depth, intr)
    model_pyr = mp.build_map_pyramid(st.model_maps, 3)
    tight = torch.clamp(0.5 * st.volume.voxel_size, min=0.006)
    pose = st.model_pose
    systems = []
    for level, iters in ((2, 4), (1, 5), (0, 10)):
        lv, ln = mp.live_to_hwc(pyr.maps[level])
        mv, mn, mok, _ = mp.model_to_hwc(model_pyr[level])
        grads = icp._model_gradients(mv, mok)
        for _ in range(iters):
            a, b, _, _ = icp._normal_equations(pose, lv, ln, mv, mn, mok, grads, st.model_pose,
                                               intr.level(level), tight, 0.5236,
                                               window=icp.WINDOWS[level])
            systems.append((pose, a, b, icp.DAMPINGS[level]))
            pose, _ = solve_twist_plain(pose, a, b, damping=icp.DAMPINGS[level])
    dev = depth.device
    p = st.model_pose
    for a, b in ((torch.zeros(6, 6), torch.ones(6)), (torch.full((6, 6), float("nan")), torch.ones(6)),
                 (torch.eye(6), torch.full((6,), float("nan")))):
        systems.append((p, a.to(dev), b.to(dev), 3e-4))
    return systems


def compare_k2(systems):
    """K2 against its plain version on the card on each system:
    bit-identical required on the 16 pose entries and the step norm (the
    same float32 operations in the same order, --fmad=false); a
    degenerate system must keep its pose exactly. Returns (max abs err,
    timing calls, bound)."""
    from housescan_tpu_torch.ops.solve6 import solve_twist_compose, solve_twist_plain

    n_corr_sys = len(systems) - 3
    for i, (p, a, b, damping) in enumerate(systems):
        kp, kn = solve_twist_compose(p, a, b, damping=damping)
        qp, qn = solve_twist_plain(p, a, b, damping=damping)
        torch.cuda.synchronize()
        if not (torch.equal(kp, qp) and torch.equal(kn, qn)):
            fail(f"K2 differs from its plain version on system {i}: pose by "
                 f"{float((kp - qp).abs().max())}, step norm {float(kn)} vs {float(qn)}")
        if i >= n_corr_sys and not (torch.equal(kp, p) and float(kn) <= 1e-9):
            fail(f"K2 moved the pose on degenerate system {i - n_corr_sys}")
    p, a, b, damping = systems[n_corr_sys - 1]  # the finest level's last system
    calls = (lambda: solve_twist_compose(p, a, b, damping=damping),
             lambda: solve_twist_plain(p, a, b, damping=damping))
    # 58 floats in, 17 out; ~700 float ops (the Cholesky, two solves, the
    # matvec, Rodrigues and the 4x4 compose)
    return 0.0, calls, bound((58 + 17) * 4, 700)


def k2_readings(calls, card, reps=200):
    """K2's device time a launch by the profiler (every device kernel a
    call launches), beside its latency floor: an empty one-thread kernel
    (PyTorch's spin kernel with 0 cycles, ``torch.cuda._sleep(0)``)
    launched on the same stream and read the same way. Returns (K2's
    device us a call, the floor's)."""
    k2 = kernel_device_us(calls[0], reps)
    empty = kernel_device_us(lambda: torch.cuda._sleep(0), reps)
    k2_us, floor_us = sum(v[0] for v in k2.values()), sum(v[0] for v in empty.values())
    print(f"# K2 device time {k2_us:.3f} us a call in "
          f"{', '.join(f'{k[:60]} {v[0]:.3f} us x{v[1]:.0f}' for k, v in k2.items())}; latency "
          f"floor (an empty one-thread kernel) {floor_us:.3f} us [{card}]", flush=True)
    return k2_us, floor_us


def run_xla(intr, poses, frames, device, card):
    """Phase 9, xla-480: a warm pass over frames 0-2, the timed pass with
    launch counts and its gates, then K2 against its plain version on
    systems of the timed pass's last frame, and one more step that must
    not make the host wait on the card."""
    from housescan_tpu_torch.kinfu.pipeline import kinfu_step
    from housescan_tpu_torch.ops import cuda_lib

    st, warm_s, _ = run_orbit(intr, poses[:3], frames[:3], XLA_RES, device, dtype=torch.float32,
                              use_pallas=False)
    del st
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cuda_lib.reset_counts()
    st, secs, tracked = run_orbit(intr, poses, frames, XLA_RES, device, dtype=torch.float32,
                                  use_pallas=False)
    launches, plain = dict(cuda_lib.launch_counts), dict(cuda_lib.plain_counts)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    err_mm = float(np.linalg.norm(st.pose[3, :3].cpu().numpy() - poses[N_FRAMES][3, :3])) * 1000.0
    cover = float(st.model_maps[7].mean())
    print(f"# xla-{XLA_RES} {intr.width}x{intr.height} float32 (use_pallas=False): {N_FRAMES} frames "
          f"in {secs:.4f} s = {secs / N_FRAMES * 1000:.3f} ms/frame = {N_FRAMES / secs:.2f} fps "
          f"(warm pass of 3 frames {warm_s:.4f} s); pose error {err_mm:.3f} mm; last rmse "
          f"{float(st.last_rmse) * 1000:.4f} mm corr {int(st.last_corr)}; tracked "
          f"{sum(tracked)}/{len(tracked)}; model-map coverage {cover:.3f}; peak memory "
          f"{peak_gb:.3f} GB; K2 launches {launches['solve6']} [{card}]", flush=True)
    print(f"# xla-{XLA_RES} launches {json.dumps(launches)} plain {json.dumps(plain)}", flush=True)
    if tuple(st.volume.data.shape) != (2,) + (XLA_RES,) * 3 or st.volume.data.dtype != torch.float32:
        fail("xla-480 did not fuse into the float32 volume")
    if err_mm > POSE_BUDGET_MM:
        fail(f"xla-480 pose error {err_mm:.3f} mm exceeds {POSE_BUDGET_MM} mm")
    if not all(tracked):
        fail("xla-480 dropped a frame")
    if not bool(torch.isfinite(st.model_maps).all()) or cover < 0.5:
        fail(f"xla-480 model maps malformed or cover only {cover:.3f} of the image")
    check_counts(f"xla-{XLA_RES}", launches, plain, cuda_lib.XLA_PATH)

    systems = k2_systems(st, frames[N_FRAMES], intr)
    err, calls, k2_bound = compare_k2(systems)
    print(f"# K2 compare: {len(systems)} systems ({len(systems) - 3} from the timed xla-{XLA_RES} "
          f"pass's last frame, 3 degenerate), bit-identical", flush=True)
    k2_readings(calls, card)
    _, syncs = host_syncs(lambda: kinfu_step(st, frames[N_FRAMES], intr, use_pallas=False))
    print(f"# xla-{XLA_RES}: one more step made {len(syncs)} host synchronisations", flush=True)
    if syncs:
        fail(f"the XLA step made the host wait on the card at {syncs}")
    return dict(err=err, calls=calls, bound=k2_bound, launches=launches, secs=secs)


def timed_orbit(intr, poses, frames, device, card, dtype, warm_s):
    """The timed kernel-path pass of phases 6 and 7 on a fresh volume of
    ``dtype``, with its gates and launch counts; then one more step, which
    must not make the host wait on the card. Returns (state, seconds)."""
    from housescan_tpu_torch.kinfu.pipeline import kinfu_step
    from housescan_tpu_torch.ops import cuda_lib

    tag = f"box-{RES}" + ("" if dtype == torch.int32 else "-f32")
    cuda_lib.reset_counts()
    st, secs, tracked = run_orbit(intr, poses, frames, RES, device, dtype=dtype)
    launches, plain = dict(cuda_lib.launch_counts), dict(cuda_lib.plain_counts)
    err_mm = float(np.linalg.norm(st.pose[3, :3].cpu().numpy() - poses[N_FRAMES][3, :3])) * 1000.0
    maps = st.model_maps
    cover = float(maps[7].mean())
    print(f"# {tag} {intr.width}x{intr.height} ({LAYOUTS[dtype]} volume "
          f"{tuple(st.volume.data.shape)}): {N_FRAMES} frames in {secs:.4f} s = "
          f"{secs / N_FRAMES * 1000:.3f} ms/frame = "
          f"{N_FRAMES / secs:.2f} fps (warm pass {warm_s:.4f} s); pose error {err_mm:.3f} mm; "
          f"last rmse {float(st.last_rmse) * 1000:.4f} mm corr {int(st.last_corr)}; "
          f"tracked {sum(tracked)}/{len(tracked)}; coverage {cover:.3f} [{card}]", flush=True)
    print(f"# {tag} launches {json.dumps(launches)} plain {json.dumps(plain)}", flush=True)
    if st.volume.data.dtype != dtype:
        fail(f"{tag} did not fuse into the {LAYOUTS[dtype]} volume")
    if err_mm > POSE_BUDGET_MM:
        fail(f"{tag} pose error {err_mm:.3f} mm exceeds {POSE_BUDGET_MM} mm")
    if not all(tracked):
        fail(f"a frame of the {tag} orbit was dropped")
    if tuple(maps.shape) != (8, intr.height, intr.width) or not bool(torch.isfinite(maps).all()):
        fail(f"{tag} model maps malformed")
    if cover < 0.5:
        fail(f"{tag} model maps cover only {cover:.3f} of the image")
    check_counts(tag, launches, plain, cuda_lib.KERNEL_PATH)
    _, syncs = host_syncs(lambda: kinfu_step(st, frames[N_FRAMES], intr))
    print(f"# {tag}: one more step made {len(syncs)} host synchronisations {syncs}", flush=True)
    if syncs:
        fail(f"the {tag} step made the host wait on the card at {syncs}")
    return st, secs


def k7_oracle(st, depth, intr):
    """K7 as the oracle of K4's persistent planes (the reference's
    test_planes_match_standalone_extraction): one more integrate of
    ``depth`` at the state's pose on copies of its volume and planes, then
    a fresh extraction (K7) over the result. On every chunk of the unsplit
    work list the valid flags are identical and every field but 11 (K4's
    flags) agrees within 1e-5 where valid. Returns (max diff, listed
    chunks, valid sub-blocks)."""
    from housescan_tpu_torch.ops.chunk_select import build_worklist
    from housescan_tpu_torch.ops.planes_cuda import extract_subblock_planes
    from housescan_tpu_torch.ops.tsdf_stream import FIELD_SAT, N_QUARTERS, tsdf_integrate_stream

    vol = st.volume._replace(data=st.volume.data.clone())
    planes = st.planes.clone()
    sat = planes[:, :, :, FIELD_SAT, :N_QUARTERS].reshape(-1, N_QUARTERS) > 0.5
    wl = build_worklist(depth, st.pose, intr, vol.dims, vol.voxel_size, vol.origin, vol.trunc,
                        sat_quarters=sat)
    tsdf_integrate_stream(vol, planes, depth, st.pose, intr)
    want = extract_subblock_planes(vol)
    n = int(wl.count[0])
    d = wl.desc[:n].long()
    got, want = planes[d[:, 0], d[:, 1], d[:, 2]], want[d[:, 0], d[:, 1], d[:, 2]]
    gv, wv = got[:, 4] > 0.5, want[:, 4] > 0.5
    if not torch.equal(gv, wv):
        fail(f"K7 oracle: valid flags differ on {int((gv != wv).sum())} sub-blocks")
    keep = [f for f in range(16) if f != FIELD_SAT]
    m = wv[:, None, :].expand(n, len(keep), 16)
    diff = float((got[:, keep] - want[:, keep]).abs()[m].max()) if bool(wv.any()) else 0.0
    if diff > 1e-5 or int(wv.sum()) < 100:
        fail(f"K7 oracle: fields differ by {diff} ({int(wv.sum())} valid sub-blocks)")
    return diff, n, int(wv.sum())


def kernel_device_us(fn, reps):
    """``device_us`` of ``reps`` calls of ``fn`` after a warm call."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return device_us(prof, reps)


def compare_extract(vol, tag, card, reps=20):
    """K7 against its plain version on a volume of either layout:
    bit-identical required (both sum the moments in float64 and round
    once, --fmad=false). Prints the observed voxels, the kernel's device
    time by launch (the profiler) and its bound counted from the volume's
    data beside the loose one of earlier readings. Returns (max abs err,
    timing calls, bound)."""
    from housescan_tpu_torch.ops.planes_cuda import (
        _extract_params, extract_planes_plain, launch_extract_kernel,
    )

    nx, ny, nz = vol.dims
    params7 = _extract_params(vol, 6.0, nx // 8)
    k7 = launch_extract_kernel(vol.data, params7)
    q7 = extract_planes_plain(vol.data, params7)
    torch.cuda.synchronize()
    err7 = float((k7 - q7).abs().max())
    n_valid = int((q7[:, :, :, 4] > 0.5).sum())
    if not torch.equal(k7, q7) or n_valid < 1000:
        fail(f"K7 ({tag}) differs from its plain version by {err7} ({n_valid} valid sub-blocks)")
    t, w = _tw(vol.data)
    obs = w > 0
    observed = int(obs.sum())
    # 32-byte z-segments (a sub-block's 8 voxels of one (x, y) row) holding
    # an observed voxel: the tsdf sectors a weight-first read must fetch
    segments = int(obs.reshape(nx, ny, nz // 8, 8).any(-1).sum())
    grid = (nx // 8, 8, ny // 8, 8)
    n_chunks = int(obs.reshape(*grid, nz // 128, 128).any(5).any(3).any(1).sum())
    sub_obs = obs.reshape(*grid, nz // 8, 8).any(5).any(3).any(1)
    # sub-blocks that can have a moment term: an observed voxel below 0.99
    # in the sub-block or in the next one's first slice within the chunk
    low = obs & (t < 0.99)
    del t, w, obs
    cand = low.reshape(*grid, nz // 8, 8).any(5).any(3).any(1)
    nxt = low[:, :, 8::8].reshape(*grid, nz // 8 - 1).any(3).any(1)
    del low
    keep = (torch.arange(1, nz // 8, device=cand.device) % 16) != 0
    cand[:, :, :-1] |= nxt & keep
    n_sub, n_cand = int(sub_obs.sum()), int(cand.sum())
    del sub_obs, cand, nxt
    voxels = nx * ny * nz
    out_bytes = k7.numel() * 4
    # the least bytes: float32, every weight and the tsdf of the observed
    # voxels (an unobserved voxel reads no neighbour and adds no term);
    # packed, every cell (both values in one word); the planes written. ~30
    # float ops an observed voxel (crossing tests, moment terms)
    packed = vol.data.dim() == 3
    need = 4 * voxels + (0 if packed else 4 * observed) + out_bytes
    tight = bound(need, 30 * observed)
    loose = bound((4 if packed else 8) * voxels + out_bytes, 30 * voxels)
    calls = (lambda: launch_extract_kernel(vol.data, params7),
             lambda: extract_planes_plain(vol.data, params7))
    dev = kernel_device_us(calls[0], reps)
    print(f"# K7 compare ({tag} volume {tuple(vol.data.shape)}): {n_valid} valid sub-blocks, "
          f"bit-identical; {observed} observed voxels ({observed / voxels * 100:.3f}%) in "
          f"{segments} 32-byte z-segments, {n_sub} sub-blocks ({n_cand} with a voxel below "
          f"0.99 that a term needs) and {n_chunks} chunks of {voxels // CHUNK_VOXELS}; device "
          f"by launch: "
          f"{', '.join(f'{k[:50]} {v[0]:.1f} us x{v[1]:.0f}' for k, v in dev.items())}; bound "
          f"counted from the data {need / 1e6:.1f} MB, {tight[0]:.4f} ms ({tight[1]}); the "
          f"loose one of earlier readings (every voxel read) {loose[0]:.4f} ms [{card}]",
          flush=True)
    return err7, calls, tight


def render_ms(vol, pose, intr, card, reps=10):
    """dense-512's render: one ``raycast_pallas`` call (K7, the tile
    candidates, K6, the seam and skirt masks) on the fused volume, by CUDA
    events. Returns ms a call."""
    from housescan_tpu_torch.ops.raycast_planes import raycast_pallas

    ms = cuda_ms(lambda: raycast_pallas(vol, pose, intr), reps)
    print(f"# dense-{RES} render (raycast_pallas: K7, candidates, K6, masks): {ms:.4f} ms a "
          f"call (CUDA events) [{card}]", flush=True)
    return ms


def compare_dense(intr, frames, pose_t, device, card, reps=10):
    """K8 against its plain version on dense-512's compare input: frame 1 on
    a float32 volume carried from frame 0, bit-identical expected
    (--fmad=false, the same operation order): classes, weights, tsdf and
    planes. Prints the chunk classes, the kernel's time (CUDA events),
    its device time by launch (the profiler) and its achieved bandwidth
    against the bound. Returns (max abs err, timing calls, bound)."""
    from housescan_tpu_torch.kinfu.tsdf import tsdf_new
    from housescan_tpu_torch.ops.tsdf_cuda import (
        CLS_BAND, CLS_FREE, CLS_SKIP, dense_inputs, dense_integrate_plain, launch_dense_kernel,
        tsdf_integrate_with_planes,
    )

    v0 = tsdf_new(RES, 3.0, 0.03, dtype=torch.float32, device=device)
    tsdf_integrate_with_planes(v0, frames[0], pose_t[0], intr)
    mips, params = dense_inputs(v0, frames[1], pose_t[1], intr)
    kd = v0.data.clone()
    kc, kp = launch_dense_kernel(kd, mips, params)
    qd = v0.data.clone()
    qc, qp = dense_integrate_plain(qd, mips, params)
    torch.cuda.synchronize()
    err8 = max(float((kd - qd).abs().max()), float((kp - qp).abs().max()))
    same = torch.equal(kc, qc) and torch.equal(kd, qd) and torch.equal(kp, qp)
    if not same:
        fail(f"K8 differs from its plain version: classes equal {torch.equal(kc, qc)}, "
             f"weights equal {torch.equal(kd[1], qd[1])}, tsdf equal {torch.equal(kd[0], qd[0])}, "
             f"planes equal {torch.equal(kp, qp)}, max abs err {err8}")
    n_cls = {name: int((kc == c).sum()) for name, c in
             (("SKIP", CLS_SKIP), ("FREE", CLS_FREE), ("BAND", CLS_BAND))}
    n_visited = kc.numel() - n_cls["SKIP"]
    # a voxel unobserved before the frame needs no tsdf read (the integrate
    # weighs its old tsdf by 0, the fit skips it); a word that does not
    # change need not be written (words compared as bits)
    observed = int((v0.data[1] > 0).sum())
    observed_after = int((kd[1] > 0).sum())
    words = int((kd.view(torch.int32) != v0.data.view(torch.int32)).sum())
    print(f"# K8 compare (frame 1 on frame 0): chunk classes {json.dumps(n_cls)} of {kc.numel()}, "
          f"{observed} voxels observed before the frame, {observed_after} after, {words} volume "
          f"words changed; classes, weights, tsdf and planes bit-identical", flush=True)
    del kd, qd
    scratch = v0.data
    calls = (lambda: launch_dense_kernel(scratch, mips, params),
             lambda: dense_integrate_plain(scratch, mips, params))
    # the least bytes: every weight read, the tsdf of the voxels observed
    # before the frame read, the changed words written, the frame read, the
    # planes and classes written; ~30 float ops an observed voxel for the fit
    # and ~60 a visited voxel for the integrate
    io_bytes = intr.width * intr.height * 4 + kp.numel() * 4 + kc.numel() * 4
    n_bytes = 4 * RES ** 3 + 4 * observed + 4 * words + io_bytes
    k8_bound = bound(n_bytes, 30 * observed_after + 60 * CHUNK_VOXELS * n_visited)
    # the looser bound of earlier readings, kept to compare with them: every voxel
    # read (8 bytes), every visited chunk written whole
    loose = bound(8 * RES ** 3 + 8 * CHUNK_VOXELS * n_visited + intr.width * intr.height * 4
                  + kp.numel() * 4, 30 * RES ** 3 + 60 * CHUNK_VOXELS * n_visited)
    ms = cuda_ms(calls[0], reps)
    torch.cuda._sleep(QUEUE_CYCLES)
    t0 = time.perf_counter()
    for _ in range(reps):
        calls[0]()
    host_us = (time.perf_counter() - t0) / reps * 1e6
    torch.cuda.synchronize()
    split = kernel_device_us(calls[0], reps)
    print(f"# K8 {ms:.4f} ms a call (CUDA events), the wrapper's host work {host_us:.1f} us a "
          f"call, device by launch: "
          f"{', '.join(f'{k[:60]} {v[0]:.1f} us x{v[1]:.0f}' for k, v in split.items())}; "
          f"{n_bytes / 1e6:.1f} MB at bound {k8_bound[0]:.4f} ms ({k8_bound[1]}): achieved "
          f"{n_bytes / ms / 1e6:.1f} GB/s of {HBM_BYTES_PER_S / 1e9:.0f} "
          f"({k8_bound[0] / ms * 100:.1f}% of the bound); the earlier loose bound (every voxel "
          f"read, every visited chunk written whole) {loose[0]:.4f} ms, "
          f"{loose[0] / ms * 100:.1f}% of it [{card}]", flush=True)
    return err8, calls, k8_bound


def run_dense(intr, poses, frames, device, card):
    """Phase 11, dense-512: path (B) with its gates, then K8 and K7 against
    their plain versions and K8 against K4. Returns the two kernels'
    errors, timing calls, bounds and launches."""
    from housescan_tpu_torch.kinfu.camera import Intrinsics
    from housescan_tpu_torch.kinfu.synthetic import furnished_room, orbit_poses, render_depth_stream
    from housescan_tpu_torch.kinfu.tsdf import tsdf_new
    from housescan_tpu_torch.ops import cuda_lib
    from housescan_tpu_torch.ops.raycast_planes import raycast_pallas
    from housescan_tpu_torch.ops.tsdf_cuda import tsdf_integrate_with_planes
    from housescan_tpu_torch.ops.tsdf_stream import planes_shape, tsdf_integrate_stream

    pose_t = [torch.from_numpy(p).to(device) for p in poses]
    tag = f"dense-{RES}"

    def fresh():
        return tsdf_new(RES, 3.0, 0.03, dtype=torch.float32, device=device)

    # the path: K8 over the 21 frames at their true poses, then model maps
    cuda_lib.reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    vol = fresh()
    for d, p in zip(frames, pose_t):
        vol, _ = tsdf_integrate_with_planes(vol, d, p, intr)
    torch.cuda.synchronize()
    fuse_s = time.perf_counter() - t0
    maps = {k: raycast_pallas(vol, pose_t[k], intr) for k in (N_FRAMES, 0)}
    torch.cuda.synchronize()
    launches, plain = dict(cuda_lib.launch_counts), dict(cuda_lib.plain_counts)
    print(f"# {tag}: {N_FRAMES + 1} frames fused by K8 in {fuse_s:.4f} s = "
          f"{fuse_s / (N_FRAMES + 1) * 1000:.3f} ms/frame (host clock, first call included) "
          f"[{card}]", flush=True)
    print(f"# {tag} launches {json.dumps(launches)} plain {json.dumps(plain)}", flush=True)
    check_counts(tag, launches, plain, cuda_lib.DENSE_PATH)
    for k, m in maps.items():
        valid = m[7] > 0.5
        cover = float(valid.float().mean())
        both = valid & (frames[k] > 0)
        err = (m[0] - frames[k]).abs()[both]
        med, tail = float(err.median()), float((err > 0.01).float().mean())
        print(f"# {tag} raycast_pallas at pose {k}: coverage {cover:.4f}, median |depth - true| "
              f"{med * 1000:.5f} mm on {int(both.sum())} pixels, > 10 mm on {tail * 100:.3f}%",
              flush=True)
        if not bool(torch.isfinite(m).all()) or cover <= 0.55 or med >= 0.0005 or tail >= 0.04:
            fail(f"{tag} depth quality at pose {k}: coverage {cover}, median {med}, tail {tail}")

    err7, k7_calls, k7_bound = compare_extract(vol, tag, card)
    render_ms(vol, pose_t[N_FRAMES], intr, card)
    del maps

    err8, k8_calls, k8_bound = compare_dense(intr, frames, pose_t, device, card)

    # K8 against K4 on frame 0 from fresh volumes. The reference's
    # test_matches_dense_pallas_kernel (128^3, 0.06 m truncation, 160x120)
    # holds them to weights on >= 99.9% of voxels and a tsdf p99 |diff| <
    # 1e-5; its twin runs on the card at that configuration. At full width
    # (0.03 m truncation) the same depth differences count double in tsdf
    # units, and K4's 1/256 snap of u, its all-valid shortcut and its
    # edge-replicated padding (K8 renormalises, snaps nothing and pads with
    # zeros) move the bilinear depth by a few ulps (~1e-6 m at 2 m, 3e-5
    # of the truncation): gated at 1e-4.
    half, boxes = furnished_room()
    small = Intrinsics(*SMALL_CAM)
    twin_poses = orbit_poses(2, radius=0.25, yaw_range=0.05, pitch=0.25)
    twin_depth = render_depth_stream(small, twin_poses, half, boxes, device=device)[0]
    for what, res, trunc, cam, depth0, pose0, limit in (
            ("the reference's test, 128^3", 128, 0.06, small, twin_depth,
             torch.from_numpy(twin_poses[0]).to(device), 1e-5),
            (f"{RES}^3, the orbit's frame 0", RES, 0.03, intr, frames[0], pose_t[0], 1e-4)):
        va = tsdf_new(res, 3.0, trunc, dtype=torch.float32, device=device)
        vb = tsdf_new(res, 3.0, trunc, dtype=torch.float32, device=device)
        tsdf_integrate_with_planes(va, depth0, pose0, cam)
        tsdf_integrate_stream(vb, torch.zeros(planes_shape(res), device=device), depth0, pose0,
                              cam)
        agree = float((va.data[1] == vb.data[1]).float().mean())
        both = (va.data[1] > 0) & (vb.data[1] > 0)
        diff = (va.data[0] - vb.data[0]).abs()[both]
        p99 = float(diff.kthvalue(max(1, int(0.99 * diff.numel()))).values)
        print(f"# K8 vs K4 ({what}, fresh volumes): weights agree on {agree * 100:.4f}% of "
              f"voxels, tsdf p99 |diff| {p99:.3e} on {diff.numel()} jointly observed voxels "
              f"(bound {limit:g})", flush=True)
        if agree < 0.999 or p99 >= limit:
            fail(f"K8 and K4 disagree ({what}): weights {agree}, tsdf p99 {p99}")
    del va, vb, diff
    return dict(errs={"planes_extract": err7, "tsdf_dense": err8},
                calls={"planes_extract": k7_calls, "tsdf_dense": k8_calls},
                bounds={"planes_extract": k7_bound, "tsdf_dense": k8_bound},
                launches=launches)


# CUDA-event calls a timing (kernel, plain version)
REPS = {"bilateral": (50, 3), "icp_level": (20, 2), "tsdf_stream": (5, 1),
        "tsdf_free": (20, 1), "raycast_tiles": (50, 2), SMALL_K6: (50, 2), "solve6": (200, 3),
        "planes_extract": (20, 1), PACKED_K7: (20, 1), "tsdf_dense": (10, 1)}


def warm_states(intr, poses, frames, device, dtype):
    """(the state after a warm orbit on a fresh ``dtype`` volume, the state
    after frame 0 alone, the warm pass's seconds)."""
    from housescan_tpu_torch.kinfu.pipeline import kinfu_init, kinfu_step

    st, warm_s, _ = run_orbit(intr, poses, frames, RES, device, dtype=dtype)
    st0 = kinfu_init(intr, resolution=RES, size_m=3.0, trunc=0.03, init_pose=poses[0],
                     dtype=dtype, device=device)
    return st, kinfu_step(st0, frames[0], intr), warm_s


def box_kernels(intr, poses, frames, device, card):
    """Phase 4 on the packed volume: each main-path kernel against its
    plain version, K7 on the warm state's volume, K3's level calls and K4
    on an empty list. Returns (errors, timing calls, bounds, list sizes,
    warm pass seconds, the warm state)."""
    pose1 = torch.from_numpy(poses[1]).to(device)
    st, st0, warm_s = warm_states(intr, poses, frames, device, torch.int32)
    errs, calls, bounds, sizes = compare_kernels(st, st0, intr, frames[N_FRAMES], frames[1], pose1,
                                                 card)
    errs[PACKED_K7], calls[PACKED_K7], bounds[PACKED_K7] = compare_extract(
        st.volume, f"box-{RES} packed", card)
    print(f"# compare: max abs err {json.dumps(errs)}", flush=True)
    icp_levels(st, frames[N_FRAMES], intr, card)
    stream_empty_list(st, frames[N_FRAMES], intr, card)
    return errs, calls, bounds, sizes, warm_s, st


def f32_kernels(intr, poses, frames, device, card):
    """Phase 7's kernels on the float32 volume: K4 and K5 against their
    plain versions, K4 on an empty list. Returns ({kernel: its compare_*
    result}, the warm state, warm pass seconds)."""
    pose1 = torch.from_numpy(poses[1]).to(device)
    st, st0, warm_f = warm_states(intr, poses, frames, device, torch.float32)
    f32 = {"tsdf_stream": compare_stream(st, frames[N_FRAMES], intr),
           "tsdf_free": compare_free(st, st0, frames[N_FRAMES], frames[1], pose1, intr,
                                         card)}
    stream_empty_list(st, frames[N_FRAMES], intr, card)
    return f32, st, warm_f


def time_kernels(names, calls, bounds, card, launches=None):
    """Phase 12: each kernel of ``names`` and its plain version by CUDA
    events, beside its bound (and its launches on its path's run, where
    given). Returns {kernel: (ms, plain ms)}."""
    out = {}
    for name in names:
        k_fn, q_fn = calls[name]
        ms, plain_ms = cuda_ms(k_fn, REPS[name][0]), cuda_ms(q_fn, REPS[name][1])
        out[name] = (ms, plain_ms)
        bound_ms, bound_by = bounds[name]
        where = "" if name not in (launches or {}) else \
            f", {launches[name]} launches on its path's run of {N_FRAMES + 1} frames"
        print(f"# {name}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bound_ms:.3e} ms "
              f"({bound_by}){where} [{card}]", flush=True)
    return out


def time_f32(f32, card):
    """Phase 12 for K4 and K5 on the float32 volume."""
    for name, (err, (k_fn, q_fn), (bound_ms, bound_by), *_) in f32.items():
        ms = cuda_ms(k_fn, REPS[name][0])
        plain_ms = cuda_ms(q_fn, REPS[name][1])
        print(f"# {name} (float32 volume, box-{RES}-f32): kernel {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms, bound {bound_ms:.3e} ms ({bound_by}), max abs err {err} "
              f"[{card}]", flush=True)


def probe(intr, poses, frames, device, card):
    """``--probe``: phase 4, phase 7's kernels, phase 12's times of the
    main path's kernels on both layouts (K1's device time and estimated issue floor
    too), K8 on dense-512's compare input (bit-identical, chunk classes,
    device time by launch, bandwidth) and K7 on the orbit fused by K8,
    both then timed as in phase 12, every kernel's resident blocks an SM,
    and phase 13's device time a step on both layouts."""
    errs, calls, bounds, _, _, st_box = box_kernels(intr, poses, frames, device, card)
    f32, st, _ = f32_kernels(intr, poses, frames, device, card)
    del st
    torch.cuda.empty_cache()
    time_kernels(list(calls), calls, bounds, card)
    k1_readings(intr, calls, card)
    time_f32(f32, card)
    # K8 on dense-512's compare input and K7 on the orbit fused by K8 (phase
    # 11), timed as phase 12 times them
    from housescan_tpu_torch.kinfu.tsdf import tsdf_new
    from housescan_tpu_torch.ops.tsdf_cuda import tsdf_integrate_with_planes

    pose_t = [torch.from_numpy(p).to(device) for p in poses]
    dense = {}
    _, dense["tsdf_dense"], k8_bound = compare_dense(intr, frames, pose_t, device, card)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    vol = tsdf_new(RES, 3.0, 0.03, dtype=torch.float32, device=device)
    for d, p in zip(frames, pose_t):
        vol, _ = tsdf_integrate_with_planes(vol, d, p, intr)
    torch.cuda.synchronize()
    fuse_s = time.perf_counter() - t0
    print(f"# dense-{RES}: {N_FRAMES + 1} frames fused by K8 in {fuse_s:.4f} s = "
          f"{fuse_s / (N_FRAMES + 1) * 1000:.3f} ms/frame (host clock, K8 warm) [{card}]",
          flush=True)
    _, dense["planes_extract"], k7_bound = compare_extract(vol, f"dense-{RES}", card)
    render_ms(vol, pose_t[N_FRAMES], intr, card)
    time_kernels(list(dense), dense, {"tsdf_dense": k8_bound, "planes_extract": k7_bound}, card)
    del dense, vol
    torch.cuda.empty_cache()
    occupancy_report(intr, card)
    for tag, kw, name, before in PROFILES[:2]:
        report_profile(tag, intr, poses, frames, device, card, None, kw, name, before)
    # K2 on the systems of box-512's warm state (the probe runs no xla-480)
    systems = k2_systems(st_box, frames[N_FRAMES], intr)
    _, k2_calls, k2_bound = compare_k2(systems)
    print(f"# K2 compare: {len(systems)} systems ({len(systems) - 3} from box-{RES}'s warm "
          f"state, 3 degenerate), bit-identical", flush=True)
    k2_readings(k2_calls, card)
    time_kernels(["solve6"], {"solve6": k2_calls}, {"solve6": k2_bound}, card)


NOISE = 0.002  # phase 14's sensor noise: sigma at 2 m, bench.py's HOUSESCAN_BENCH_NOISE
# Phase 14's worlds: (cell, noise, bench.py's pose-budget factor; the
# curved world's budget is 2.5 times the box world's, bench.py:259-266)
WORLDS = ((f"curved-{RES}", 0.0, 2.5), (f"noisy-{RES}", NOISE, 1.0))


def world_frames(intr, poses, device, noise):
    """Phase 14's frames of the bench orbit: the curved world noiseless
    (bench.py with HOUSESCAN_BENCH_WORLD=curved), or the box world with
    depth noise ``noise`` drawn from seed 0 and rounded through uint16
    millimetres (HOUSESCAN_BENCH_NOISE and HOUSESCAN_BENCH_QUANT=1)."""
    from housescan_tpu_torch.kinfu.synthetic import (
        curved_furnished_room, furnished_room, render_depth_stream,
    )

    if not noise:
        half, boxes, spheres, cyls, obbs = curved_furnished_room()
        return render_depth_stream(intr, poses, half, boxes, spheres=spheres, cylinders=cyls,
                                   obbs=obbs, device=device)
    half, boxes = furnished_room()
    frames = render_depth_stream(intr, poses, half, boxes, noise=noise, seed=0, device=device)
    return torch.round(frames * 1000.0).to(torch.int32).to(torch.float32) / 1000.0


def run_worlds(intr, poses, device, card):
    """Phase 14: the curved world and the noisy, quantised world on the
    kernel path at box-512's setup. Each orbit runs once from a fresh
    packed volume with the launch counts set to 0 before it: every kernel
    of the path launched, no plain version, no frame dropped, the pose
    error within bench.py's budget ((0.15 + 150 noise) mm a frame + 2 mm,
    x2.5 in the curved world: 12.5 and 11.0 mm), and one more step makes
    no host synchronisation; then its device time a step (profiler, 3
    steps) and, on its last frame, K1, K3, K4, K5 and K6 against their
    plain versions with phase 4's bounds (``compare_kernels``)."""
    from housescan_tpu_torch.kinfu.pipeline import kinfu_init, kinfu_step
    from housescan_tpu_torch.ops import cuda_lib

    pose1 = torch.from_numpy(poses[1]).to(device)
    for tag, noise, factor in WORLDS:
        frames = world_frames(intr, poses, device, noise)
        budget = ((0.15 + 150.0 * noise) * N_FRAMES + 2.0) * factor
        cuda_lib.reset_counts()
        st, secs, tracked = run_orbit(intr, poses, frames, RES, device)
        launches, plain = dict(cuda_lib.launch_counts), dict(cuda_lib.plain_counts)
        err_mm = float(np.linalg.norm(st.pose[3, :3].cpu().numpy() - poses[N_FRAMES][3, :3])) * 1e3
        print(f"# {tag} {intr.width}x{intr.height} (packed volume): {N_FRAMES} frames in "
              f"{secs:.4f} s = {secs / N_FRAMES * 1000:.3f} ms/frame = {N_FRAMES / secs:.2f} fps; "
              f"pose error {err_mm:.3f} mm (budget {budget:.1f}); tracked "
              f"{sum(tracked)}/{len(tracked)}; last rmse {float(st.last_rmse) * 1000:.4f} mm corr "
              f"{int(st.last_corr)} [{card}]", flush=True)
        print(f"# {tag} launches {json.dumps(launches)} plain {json.dumps(plain)}", flush=True)
        check_counts(tag, launches, plain, cuda_lib.KERNEL_PATH)
        if not all(tracked):
            fail(f"{tag}: {len(tracked) - sum(tracked)} frame(s) dropped")
        if err_mm > budget:
            fail(f"{tag} pose error {err_mm:.3f} mm exceeds {budget:.1f} mm")
        _, syncs = host_syncs(lambda: kinfu_step(st, frames[N_FRAMES], intr))
        print(f"# {tag}: one more step made {len(syncs)} host synchronisations {syncs}", flush=True)
        if syncs:
            fail(f"the {tag} step made the host wait on the card at {syncs}")
        dev_ms, n_launch = profile_steps(intr, poses, frames, RES, device,
                                         os.path.join(OUT, f"profile_{tag}.txt"))[:2]
        print(f"# {tag}: device kernel time {dev_ms:.3f} ms/step in {n_launch:.0f} launches/step "
              f"(profiler, 3 steps) [{card}]", flush=True)
        st0 = kinfu_init(intr, resolution=RES, size_m=3.0, trunc=0.03, init_pose=poses[0],
                         dtype=torch.int32, device=device)
        st0 = kinfu_step(st0, frames[0], intr)
        errs = compare_kernels(st, st0, intr, frames[N_FRAMES], frames[1], pose1, card)[0]
        print(f"# {tag} compare (last frame, phase 4's bounds): max abs err {json.dumps(errs)}",
              flush=True)
        del st, st0, frames
        torch.cuda.empty_cache()


def room_poses(ri):
    """Room ``ri``'s known poses, as tests/test_end_to_end.py scans it: the
    walls up and down, a floor pass and a ceiling pass, 8 poses each."""
    from housescan_tpu_torch.kinfu.synthetic import orbit_poses

    sweeps = [orbit_poses(8, radius=0.25, yaw_range=6.283, pitch=p, seed=ri) for p in (0.35, -0.35)]
    sweeps.append(orbit_poses(8, radius=0.7, height=-0.6, yaw_range=6.283, pitch=-1.2, seed=ri))
    sweeps.append(orbit_poses(8, radius=0.7, height=0.6, yaw_range=6.283, pitch=1.2, seed=ri))
    return np.concatenate(sweeps)


ROOM_PHASES = ("load", "corners", "cuboid", "move", "walls", "optimize", "xf", "export")


def room_cycle(dirs, device, out):
    """The room stage over the scanned room directories with every scene on
    ``device``: load, corners (suggestions accepted as
    tests/test_end_to_end.py accepts them), cuboid fit, room 1 moved 3 m
    along x, the facing walls connected, positions optimised, .xf files,
    placed full-resolution clouds; that test's assertions. Returns (the
    rooms, their cuboid rmse, the optimiser's results, the .xf matrices,
    placed point counts, host seconds by phase)."""
    from itertools import product

    from housescan_tpu_torch.io.pcd import load_pcd
    from housescan_tpu_torch.io.xf import load_xf
    from housescan_tpu_torch.rooms import (
        Scene, WallRelation, connect_walls, export_all_room_xf_files, export_room_full_res,
        fit_cuboid_to_room, load_room, optimize_room_positions, suggest_corners, translate_room,
    )
    from housescan_tpu_torch.rooms.corners import accept_corner_suggestion

    secs = dict.fromkeys(ROOM_PHASES, 0.0)
    clock = [time.perf_counter()]

    def lap(name):
        if device == "cuda":
            torch.cuda.synchronize()
        now = time.perf_counter()
        secs[name] += now - clock[0]
        clock[0] = now

    scene = Scene(device=device)
    rooms = []
    for d in dirs:
        room = load_room(scene, d)
        lap("load")
        room = suggest_corners(scene, room, cutoff_factor=1.3)
        if len(room.planes) < 6 or (len(room.corners) != 8 and len(room.suggested_corners) < 8):
            fail(f"rooms on {device}: {d} has {len(room.planes)} planes, {len(room.corners)} "
                 f"corners, {len(room.suggested_corners)} suggestions")
        if len(room.corners) != 8:
            pts = room.cloud.points
            lo, hi = pts.min(0), pts.max(0)
            for sx, sy, sz in product((0, 1), repeat=3):
                target = np.array([[lo[0], hi[0]][sx], [lo[1], hi[1]][sy], [lo[2], hi[2]][sz]])
                sid, spt = min(room.suggested_corners, key=lambda s: np.linalg.norm(s[1] - target))
                if np.linalg.norm(spt - target) >= 0.05:
                    fail(f"rooms on {device}: no corner suggestion within 5 cm of {target}")
                room = accept_corner_suggestion(scene, room, sid)
        if len(room.corners) != 8:
            fail(f"rooms on {device}: {d} has {len(room.corners)} corners")
        rooms.append(room)
        lap("corners")
    rmses = []
    for i, room in enumerate(rooms):
        fit = fit_cuboid_to_room(scene, room)
        if fit is None or not fit[1] < 0.02:
            fail(f"rooms on {device}: room {i} cuboid fit {None if fit is None else fit[1]}")
        rooms[i] = fit[0]
        rmses.append(fit[1])
    lap("cuboid")
    scene.update_room(translate_room(scene.rooms[rooms[1].room_id],
                                     np.array([3.0, 0.0, 0.0], np.float32), device=device))
    lap("move")
    p0 = min(scene.rooms[rooms[0].room_id].planes, key=lambda p: p.normal[0])
    p1 = max(scene.rooms[rooms[1].room_id].planes, key=lambda p: p.normal[0])
    if connect_walls(scene, p0.plane_id, p1.plane_id, WallRelation.opposite(0.1)) is None:
        fail(f"rooms on {device}: the facing walls did not connect")
    lap("walls")
    results = optimize_room_positions(scene)
    if not results or not all(np.isfinite(r[2]) for r in results):
        fail(f"rooms on {device}: optimize_room_positions gave {results}")
    lap("optimize")
    xfs = export_all_room_xf_files(scene, os.path.join(out, f"xf_{device}"))
    if len(xfs) != 2:
        fail(f"rooms on {device}: {len(xfs)} .xf files")
    lap("xf")
    placed = []
    for room in rooms:
        path = export_room_full_res(scene.rooms[room.room_id],
                                    os.path.join(out, f"placed_{device}_{room.room_id}.pcd"),
                                    device=device)
        placed.append(len(load_pcd(path)))
    lap("export")
    if min(placed) <= 1000:
        fail(f"rooms on {device}: placed clouds of {placed} points")
    return ([scene.rooms[r.room_id] for r in rooms], rmses, results, [load_xf(x) for x in xfs],
            placed, secs)


def run_rooms(intr, device, card):
    """Phase 15: two rooms scanned with ``scan_to_room_dir`` at ``Config()``
    (512^3 float32, 640x480; 32 known poses each, tests/test_end_to_end.py's
    sweeps), then the room stage on the card (``room_cycle``), then again
    on the CPU from the same directories; the card held to the CPU:
    corners within 1e-4 m (as point sets: a cuboid's parametrisation is
    not unique), cuboid rmse within 1e-5, optimised corner means within
    1e-4 m, .xf matrices within 1e-5. The card's cycle runs twice, the
    first paying its libraries' first calls, and both are timed."""
    from housescan_tpu_torch.capture.replay import DepthStream
    from housescan_tpu_torch.config import Config
    from housescan_tpu_torch.kinfu.scan import scan_to_room_dir
    from housescan_tpu_torch.kinfu.synthetic import furnished_room, render_depth_stream
    from housescan_tpu_torch.ops import cuda_lib

    out = os.path.join(OUT, "rooms")
    shutil.rmtree(out, ignore_errors=True)
    half, boxes = furnished_room()
    dirs = []
    cuda_lib.reset_counts()
    for ri in range(2):
        poses = room_poses(ri)
        frames = render_depth_stream(intr, poses, half, boxes, seed=ri, device=device).cpu().numpy()
        timings = {}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dirs.append(scan_to_room_dir(DepthStream(frames=frames, intrinsics=intr),
                                     os.path.join(out, f"scan{ri}"), config=Config(),
                                     init_pose=poses[0], known_poses=poses, timings=timings))
        print(f"# rooms: scan {ri} at Config() ({len(poses)} known poses): "
              f"{time.perf_counter() - t0:.4f} s, "
              + " ".join(f"{k} {v:.4f} s" for k, v in timings.items()) + f" [{card}]", flush=True)
        del frames
    launches, plain = dict(cuda_lib.launch_counts), dict(cuda_lib.plain_counts)
    print(f"# rooms: scans' launches {json.dumps(launches)} plain {json.dumps(plain)}", flush=True)
    # known poses skip ICP, so K3 does not run
    check_counts("the room scans", launches, plain,
                 tuple(k for k in cuda_lib.KERNEL_PATH if k != "icp_level"))
    torch.cuda.empty_cache()

    # the card's first cycle pays its libraries' first calls; the second is warm
    res = {run: room_cycle(dirs, run.split()[0], out) for run in ("cuda", "cuda warm", "cpu")}
    (gr, grm, gres, gxf, gpl, _), (cr, crm, cres, cxf, cpl, _) = res["cuda"], res["cpu"]
    for run, r in res.items():
        s = r[-1]
        print(f"# rooms on {run}: host seconds " + " ".join(f"{k} {s[k]:.4f}" for k in ROOM_PHASES)
              + f"; total {sum(s.values()):.4f} s [{card}]", flush=True)
    corner_err = 0.0
    for a, b in zip(gr, cr):
        ca, cb = (np.stack([c for _, c in r.corners]) for r in (a, b))
        dist = np.linalg.norm(ca[:, None] - cb[None], axis=-1)
        corner_err = max(corner_err, float(dist.min(axis=1).max()), float(dist.min(axis=0).max()))
    rmse_err = max(abs(a - b) for a, b in zip(grm, crm))
    pos_err = max(float(np.abs(a.corner_mean() - b.corner_mean()).max()) for a, b in zip(gr, cr))
    xf_err = max(float(np.abs(a - b).max()) for a, b in zip(gxf, cxf))
    print(f"# rooms: {[len(r.planes) for r in gr]} planes after the fit, cuboid rmse "
          f"{[f'{x:.6f}' for x in grm]} m, optimiser {[(int(a), n, f'{r:.3e}') for a, n, r in gres]}, "
          f"placed {gpl} points; card against CPU: corners {corner_err:.3e} m, rmse {rmse_err:.3e}, "
          f"positions {pos_err:.3e} m, .xf {xf_err:.3e}", flush=True)
    if [(a, n) for a, n, _ in gres] != [(a, n) for a, n, _ in cres] or gpl != cpl:
        fail(f"rooms: the card's optimiser or export differs from the CPU's: {gres} {cres} {gpl} {cpl}")
    if corner_err > 1e-4 or rmse_err > 1e-5 or pos_err > 1e-4 or xf_err > 1e-5:
        fail("rooms: the card's room stage differs from the CPU's beyond its bounds")


def main() -> None:
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        fail("no CUDA device")
    device = torch.device("cuda")
    card = card_line()
    print(card, flush=True)
    os.makedirs(OUT, exist_ok=True)

    from housescan_tpu_torch.geometry.transform import full_fp32_matmul
    from housescan_tpu_torch.ops import cuda_lib

    full_fp32_matmul()
    cuda_lib.load()
    ptxas = [ln.strip() for ln in cuda_lib.build_info["ptxas"].splitlines()
             if "registers" in ln or "spill" in ln or "Compiling entry" in ln]
    print(f"# build: {cuda_lib.build_info['seconds']:.1f} s -> {cuda_lib.build_info['path']}", flush=True)
    for ln in ptxas:
        print(f"# ptxas: {ln}", flush=True)
    mark(3, t_start)

    intr, poses, frames = workload(device)
    if sys.argv[1:] == ["--probe"]:
        probe(intr, poses, frames, device, card)
        return

    # 4. box-512 (packed): warm orbit, then each kernel against its plain version
    errs, calls, bounds, sizes, warm_s, st = box_kernels(intr, poses, frames, device, card)
    del st
    mark(4, t_start)

    # 5. split and unsplit integrates of the orbit
    same, observed = split_orbit_identical(intr, poses, frames, device, torch.int32)
    if not same:
        fail("the orbit integrated with the free split differs from the unsplit one")
    print(f"# split vs unsplit orbit (21 integrates at the true poses): bit-identical, "
          f"{observed} observed voxels", flush=True)
    mark(5, t_start)

    # 6. the timed main-path run, with launch counts
    st, secs = timed_orbit(intr, poses, frames, device, card, torch.int32, warm_s)
    del st
    torch.cuda.empty_cache()
    mark(6, t_start)

    # 7. box-512-f32: the kernel path on the float32 volume
    f32, st, warm_f = f32_kernels(intr, poses, frames, device, card)
    same, observed = split_orbit_identical(intr, poses, frames, device, torch.float32)
    if not same:
        fail("box-512-f32: the orbit integrated with the free split differs from the unsplit one")
    print(f"# box-{RES}-f32 split vs unsplit orbit (21 integrates at the true poses): "
          f"bit-identical, {observed} observed voxels", flush=True)
    diff7, n7, v7 = k7_oracle(st, frames[N_FRAMES], intr)
    print(f"# box-{RES}-f32 K7 as the oracle of K4's planes after a step: {n7} listed chunks, "
          f"{v7} valid sub-blocks, valid flags identical, fields max diff {diff7}", flush=True)
    del st
    torch.cuda.empty_cache()
    st, secs_f = timed_orbit(intr, poses, frames, device, card, torch.float32, warm_f)
    del st
    torch.cuda.empty_cache()
    mark(7, t_start)

    # 8. the scan at full width (fuses into float32)
    scan_launches = run_scan(intr, poses, frames, card)
    torch.cuda.empty_cache()
    mark(8, t_start)

    # 9. xla-480: the XLA path's orbit, K2 against its plain version
    xla = run_xla(intr, poses, frames, device, card)
    errs["solve6"], calls["solve6"], bounds["solve6"] = xla["err"], xla["calls"], xla["bound"]
    torch.cuda.empty_cache()
    mark(9, t_start)

    # 10. scan-480: the scan takes the XLA path unasked
    run_scan(intr, poses, frames, card, res=XLA_RES)
    torch.cuda.empty_cache()
    mark(10, t_start)

    # 11. dense-512: K8, then raycast_pallas (K7, K6)
    dense = run_dense(intr, poses, frames, device, card)
    for key in ("errs", "calls", "bounds"):
        {"errs": errs, "calls": calls, "bounds": bounds}[key].update(dense[key])
    torch.cuda.empty_cache()
    mark(11, t_start)

    # 12. kernel vs plain times, CUDA events; resident blocks an SM
    occupancy_report(intr, card)
    # launches: the kernel path's from the scan, K2's from the timed xla-480
    # pass, K7's and K8's from the dense-512 run
    path_launches = dict(scan_launches, solve6=xla["launches"]["solve6"],
                         planes_extract=dense["launches"]["planes_extract"],
                         tsdf_dense=dense["launches"]["tsdf_dense"])
    times = time_kernels(list(KERNELS) + [SMALL_K6, PACKED_K7], calls, bounds, card,
                         path_launches)
    k1_readings(intr, calls, card)
    rows = []
    for name, (src, replaces) in KERNELS.items():
        bound_ms, bound_by = bounds[name]
        rows.append({"name": name, "route": "cuda", "source": src, "replaces": replaces,
                     "launches": path_launches[name], "max_abs_err": errs[name],
                     "ms": times[name][0], "plain_ms": times[name][1], "bound_ms": bound_ms,
                     "bound_by": bound_by, "library_ms": None})
    time_f32(f32, card)
    print(f"# sizes: K4 {sizes['n_listed']} listed chunks (packed), {f32['tsdf_stream'][3]} "
          f"(float32); K5 {sizes['n_sb']} superblocks / {sizes['n_members']} member chunks "
          f"(packed), {f32['tsdf_free'][3]} / {f32['tsdf_free'][4]} (float32)", flush=True)
    del dense
    torch.cuda.empty_cache()
    mark(12, t_start)

    # 13. where the device time goes, on each path
    for (tag, kw, name, before), secs_ in zip(PROFILES, (secs, secs_f, xla["secs"])):
        report_profile(tag, intr, poses, frames, device, card, secs_, kw, name, before)
    mark(13, t_start)

    # 14. the curved world and the noisy, quantised world on the kernel path
    run_worlds(intr, poses, device, card)
    mark(14, t_start)

    # 15. two scanned rooms through the room stage, on the card and the CPU
    run_rooms(intr, device, card)
    mark(15, t_start)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
