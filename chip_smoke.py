#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port on one NVIDIA GPU and check it.

Run from the repository root with one CUDA device visible:

    python3 chip_smoke.py

It uses ``housescan_tpu_torch`` only (no JAX) and runs the workload of the
reference bench: the synthetic furnished room, a 21-pose orbit
(``orbit_poses(21, radius=0.25, yaw_range=0.4, pitch=0.25)``) and 640x480
depth, on both fusion paths: the kernel path on a 512^3 int16-packed
volume over 3 m, and the XLA path (``use_pallas=False``) on a 480^3
float32 volume over 3 m, a resolution that does not tile into 128-voxel
chunks. Phases, each fatal on failure:

  1. a CUDA device must be present;
  2. print the card's name and power limit (nvidia-smi);
  3. build the kernel library from ``housescan_tpu_torch/csrc`` (one nvcc
     per source, in parallel) and print the build time and the ptxas
     register/spill lines;
  4. run the fusion orbit once (warm), then compare each kernel (K1
     bilateral, K3 ICP level, K4 stream integrate, K5 free carve, K6 plane
     raycast) with its plain PyTorch version on the card at the shapes the
     main path gives it; K5 on a free list of at least 16 superblocks
     (the state after frame 20, else after frame 0);
  5. integrate the orbit at its poses with and without the free split:
     the volumes and planes must be bit-identical;
  6. run the fusion orbit again from a fresh state, timed on the host
     clock (frames 1..20 after frame 0, ending in a synchronize), gate the
     final pose error at the reference bench's 5 mm budget, and require
     every kernel to have launched in it and no plain version to have run;
     print how often one more step makes the host wait on the card;
  7. the scan at full width: record the 21 frames, load them, and run
     ``scan_to_room_dir(config=Config(), write_mesh=True)`` into
     ``build/chip_smoke/scan_room``; the kernel launch counts of this run
     must show every kernel of the kernel path and no plain version; gate
     on no dropped frame, every reference-layout file present and
     parsing, >= 2 planes and a non-empty mesh inside the volume; print
     the pose error and the host time of each phase (fusion, surface
     points, RANSAC, marching tetrahedra, writes), then RANSAC once more
     on the same cloud, split into the detection on the card and the
     host's hulls;
  8. xla-480: the orbit on the XLA path, a warm pass, then K2 (the
     standalone solve) against its plain version on the card on the
     (A, b, pose) of real iterations of that orbit and on degenerate
     systems, one more step that must not make the host wait on the card
     (PyTorch's sync debug mode), then a timed pass with launch counts:
     pose error <= 5 mm, 20/20 tracked, model-map coverage >= 0.5, K1 and
     K2 launched, K3-K6 not, no plain version; print ms/frame, fps and
     peak memory;
  9. scan-480: ``scan_to_room_dir`` at ``Config()`` with a 480^3 volume,
     which takes the XLA path unasked, into
     ``build/chip_smoke/scan_room_480``, with phase 7's gates and launch
     counts showing K1 and K2 and no plain version;
 10. time each kernel and its plain version with CUDA events, beside its
     bound: max(bytes / 3.35 TB/s, float ops / 67 TFLOP/s) for this run's
     inputs (H100 SXM data sheet; each input byte read once, each output
     byte written once);
 11. profile three fusion steps of each path: device kernel time per step
     against the timed pass's frame time (the device's busy share), the
     launches per step, each stage's device and host time a step, the top
     kernels, and the full tables in ``build/chip_smoke/profile.txt`` and
     ``profile_xla.txt``.

Numbers are printed beside the card's name and power limit. The line
before the last is the kernels' JSON record (launches: each kernel's
path's run, the scan's for the kernel path, the timed xla-480 pass for
K2); the last line is ``{"ok": true, "device": {...}}``.
"""

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
}
HBM_BYTES_PER_S = 3.35e12  # H100 SXM
F32_OPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores
CHUNK_BYTES = 8 * 8 * 128 * 4  # one (8, 8, 128) chunk of packed int32 voxels
TILE_BYTES = 16 * 16 * 4  # one chunk's planes tile


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
    """Mean milliseconds per call by CUDA events, after one warm call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
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


def compare_kernels(st, st0, intr, depth, depth1, pose1, res):
    """Each kernel against its plain version at the main path's shapes,
    from the state after the warm orbit (K5: that state, else the state
    after frame 0 with frame 1). Returns per-kernel max abs error, the
    callables the timing phase reuses and each kernel's bound inputs."""
    from housescan_tpu_torch.kinfu import maps as mp
    from housescan_tpu_torch.kinfu.preprocess import build_pyramid
    from housescan_tpu_torch.ops.icp_cuda import BAND_H, icp_level, icp_level_plain
    from housescan_tpu_torch.ops.preprocess_cuda import bilateral_filter_cuda, bilateral_filter_plain
    from housescan_tpu_torch.ops.raycast_tiles import (
        _ray_params, build_tile_candidates, launch_raycast_kernel, raycast_tiles_plain,
    )
    from housescan_tpu_torch.ops.tsdf_stream import (
        FIELD_SAT, build_depth_mips, free_carve_plain, integrate_plain, launch_free_kernel,
        launch_stream_kernel,
    )

    errs, calls, bounds = {}, {}, {}
    h, w = intr.height, intr.width

    # K1: 9 float ops per tap (49 taps at radius 3), one read and one write a pixel
    k = bilateral_filter_cuda(depth)
    q = bilateral_filter_plain(depth)
    errs["bilateral"] = float((k - q).abs().max())
    if errs["bilateral"] > 2e-5:
        fail(f"K1 bilateral differs from its plain version by {errs['bilateral']}")
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

    # K4 on copies of the volume, on the main list left by the split: each
    # listed chunk read and written once plus its planes tile, the mips
    # read once; ~60 float ops a voxel
    vol, planes, pose = st.volume, st.planes, st.pose
    wl, fwl, params, n_sb, n_members = free_inputs(vol, planes, depth, pose, intr)
    mips = build_depth_mips(depth)
    kd, kpl = vol.data.clone(), planes.clone()
    launch_stream_kernel(kd, kpl, wl.desc, wl.count, mips, params)
    qd, qpl = vol.data.clone(), planes.clone()
    integrate_plain(qd, qpl, wl.desc, wl.count, mips, params, res // 8, res // 128)
    torch.cuda.synchronize()
    n_listed = int(wl.count[0])
    if not torch.equal(kd & 0xFFFF, qd & 0xFFFF):
        fail("K4 weights differ from the plain version")
    lsb = ((kd >> 16) - (qd >> 16)).abs()
    errs["tsdf_stream"] = float(lsb.max()) / 32767.0
    if float((lsb <= 1).float().mean()) < 0.999:
        fail("K4 packed tsdf differs by more than one step on > 0.1% of voxels")
    kv, qv = kpl[:, :, :, 4] > 0.5, qpl[:, :, :, 4] > 0.5
    if float((kv == qv).float().mean()) < 0.999:
        fail("K4 plane valid flags differ")
    both = (kv & qv)[:, :, :, None, :].expand_as(kpl)
    fdiff = float((kpl - qpl)[both].abs().max()) if bool(both.any()) else 0.0
    if fdiff > 1e-5 or not torch.equal(kpl[:, :, :, FIELD_SAT], qpl[:, :, :, FIELD_SAT]):
        fail(f"K4 plane fields differ by {fdiff}")
    print(f"# K4 compare: {n_listed} listed chunks (main list after the split), "
          f"plane field max diff {fdiff}", flush=True)
    scratch = vol.data.clone(), planes.clone()
    calls["tsdf_stream"] = (
        lambda: launch_stream_kernel(scratch[0], scratch[1], wl.desc, wl.count, mips, params),
        lambda: integrate_plain(scratch[0], scratch[1], wl.desc, wl.count, mips, params,
                                res // 8, res // 128),
    )
    mip_bytes = sum(m.numel() for m in mips) * 4
    bounds["tsdf_stream"] = bound(n_listed * (2 * CHUNK_BYTES + TILE_BYTES) + mip_bytes,
                                  60 * 8192 * n_listed)
    del kd, qd, kpl, qpl

    # K5 on copies, on a free list of >= 16 superblocks: each member chunk
    # read and written once plus its planes tile; ~30 float ops a voxel
    src = "after frame 20"
    if n_sb < 16:
        vol, planes, pose = st0.volume, st0.planes, pose1
        wl, fwl, params, n_sb, n_members = free_inputs(vol, planes, depth1, pose, intr)
        src = "after frame 0, frame 1"
    if n_sb == 0:
        fail("K5 comparison: the free work list is empty")
    kd, kpl = vol.data.clone(), planes.clone()
    launch_free_kernel(kd, kpl, fwl, params)
    qd, qpl = vol.data.clone(), planes.clone()
    free_carve_plain(qd, qpl, fwl, params)
    torch.cuda.synchronize()
    changed = int((kd != vol.data).sum())
    if not torch.equal(kd, qd) or not torch.equal(kpl, qpl):
        fail("K5 free carve differs from its plain version")
    errs["tsdf_free"] = 0.0
    print(f"# K5 compare ({src}): {n_sb} listed superblocks, {n_members} member chunks, "
          f"{changed} voxels carved, bit-identical", flush=True)
    if n_sb < 16:
        print(f"# K5 compare: only {n_sb} superblocks listed (fewer than 16)", flush=True)
    scratch5 = vol.data.clone(), planes.clone()
    calls["tsdf_free"] = (
        lambda: launch_free_kernel(scratch5[0], scratch5[1], fwl, params),
        lambda: free_carve_plain(scratch5[0], scratch5[1], fwl, params),
    )
    bounds["tsdf_free"] = bound(n_members * (2 * CHUNK_BYTES + TILE_BYTES), 30 * 8192 * n_members)
    del kd, qd, kpl, qpl

    # K6 on the state's planes at its pose: the candidates read once and
    # the 9 output rows written once; ~17 float ops per pixel and usable
    # candidate of its tile
    cand = build_tile_candidates(st.planes, st.pose, intr, st.volume)
    n_ut = -(-intr.width // 128)
    rparams = _ray_params(st.pose, intr, 0.3, n_ut)
    kr6 = launch_raycast_kernel(cand, rparams, intr.height, n_ut * 128)
    qr6 = raycast_tiles_plain(cand, rparams, intr.height, n_ut * 128)
    kval, qval = kr6[0] > 0, qr6[0] > 0
    agree = float((kval == qval).float().mean())
    bothv = kval & qval
    errs["raycast_tiles"] = float((kr6[:7] - qr6[:7])[:, bothv].abs().max())
    if agree < 0.995 or errs["raycast_tiles"] > 1e-5 or int(bothv.sum()) < 10000:
        fail(f"K6 differs: valid agreement {agree}, max diff {errs['raycast_tiles']}")
    calls["raycast_tiles"] = (
        lambda: launch_raycast_kernel(cand, rparams, intr.height, n_ut * 128),
        lambda: raycast_tiles_plain(cand, rparams, intr.height, n_ut * 128),
    )
    n_cand = int((cand[:, :, 9] > 0.5).sum())
    bounds["raycast_tiles"] = bound(cand.numel() * 4 + kr6.numel() * 4, 17 * 1024 * n_cand)
    return errs, calls, bounds, dict(n_listed=n_listed, n_sb=n_sb, n_members=n_members)


def split_orbit_identical(intr, poses, frames, device):
    """The orbit's frames integrated at its poses with and without the
    free split: final volumes and planes must be bit-identical."""
    from housescan_tpu_torch.kinfu.tsdf import tsdf_new
    from housescan_tpu_torch.ops.tsdf_stream import planes_shape, tsdf_integrate_stream

    out = []
    for split in (True, False):
        vol = tsdf_new(RES, 3.0, 0.03, device=device)
        planes = torch.zeros(planes_shape(RES), device=device)
        for d, p in zip(frames, poses):
            tsdf_integrate_stream(vol, planes, d, torch.from_numpy(p).to(device), intr,
                                  free_split=split)
        out.append((vol.data, planes))
    torch.cuda.synchronize()
    same = torch.equal(out[0][0], out[1][0]) and torch.equal(out[0][1], out[1][1])
    observed = int(((out[0][0] & 0xFFFF) > 0).sum())
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
    from housescan_tpu_torch.kinfu.pipeline import pallas_supported
    from housescan_tpu_torch.kinfu.scan import scan_to_room_dir
    from housescan_tpu_torch.ops import cuda_lib

    room = os.path.join(OUT, "scan_room" if res == RES else f"scan_room_{res}")
    shutil.rmtree(room, ignore_errors=True)
    path = record_stream(os.path.join(OUT, "orbit_stream.npz"), frames, intr, poses=poses)
    stream = load_stream(path)
    cfg = Config()
    cfg = replace(cfg, tsdf=replace(cfg.tsdf, resolution=res))
    kernel_path = pallas_supported(res)
    timings = {}
    cuda_lib.reset_counts()
    t0 = time.perf_counter()
    scan_to_room_dir(stream, room, config=cfg, init_pose=poses[0], write_mesh=True,
                     timings=timings)
    total = time.perf_counter() - t0
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
    total_attr = attr.replace("self_", "")
    cuda = torch.autograd.DeviceType.CUDA
    # the stage ranges also appear on the device timeline: not kernels
    kernels = [e for e in avgs if e.device_type == cuda and not e.key.startswith("stage:")]
    dev_ms = sum(getattr(e, attr) for e in kernels) / 1000.0 / n
    launches = sum(e.count for e in kernels) / n
    # the host side of a range: its wall time, and the device time of the
    # kernels launched inside it
    stages = {e.key[len("stage:"):]: (getattr(e, total_attr) / 1000.0 / n, e.cpu_time_total / 1000.0 / n)
              for e in avgs if e.key.startswith("stage:") and e.device_type != cuda}
    os.makedirs(os.path.dirname(out_path), exist_ok=True)
    with open(out_path, "w") as f:
        f.write(avgs.table(sort_by=attr, row_limit=60))
    top = sorted(kernels, key=lambda e: -getattr(e, attr))[:10]
    k2 = [e for e in kernels if "solve6_kernel" in e.key]
    k2_us = getattr(k2[0], attr) / k2[0].count if k2 else None
    return dev_ms, launches, [(e.key, getattr(e, attr) / 1000.0 / n, e.count / n) for e in top], \
        stages, k2_us


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
    """K2 against its plain version on the card on each system: max abs
    error over the 16 pose entries and the step norm (bound 2e-5, the
    reference's; 0 expected, as K3's inlined solve gave); a degenerate
    system must keep its pose exactly. Returns (max abs err, timing
    calls, bound)."""
    from housescan_tpu_torch.ops.solve6 import solve_twist_compose, solve_twist_plain

    err = 0.0
    n_corr_sys = len(systems) - 3
    for i, (p, a, b, damping) in enumerate(systems):
        kp, kn = solve_twist_compose(p, a, b, damping=damping)
        qp, qn = solve_twist_plain(p, a, b, damping=damping)
        torch.cuda.synchronize()
        err = max(err, float((kp - qp).abs().max()), abs(float(kn) - float(qn)))
        if i >= n_corr_sys and not (torch.equal(kp, p) and float(kn) <= 1e-9):
            fail(f"K2 moved the pose on degenerate system {i - n_corr_sys}")
    if err > 2e-5:
        fail(f"K2 differs from its plain version by {err}")
    p, a, b, damping = systems[n_corr_sys - 1]  # the finest level's last system
    calls = (lambda: solve_twist_compose(p, a, b, damping=damping),
             lambda: solve_twist_plain(p, a, b, damping=damping))
    # 58 floats in, 17 out; ~700 float ops (the Cholesky, two solves, the
    # matvec, Rodrigues and the 4x4 compose)
    return err, calls, bound((58 + 17) * 4, 700)


def run_xla(intr, poses, frames, device, card):
    """Phase 8, xla-480: a warm pass, K2 against its plain version on
    systems of that pass, then the timed pass with launch counts."""
    from housescan_tpu_torch.ops import cuda_lib

    st, warm_s, _ = run_orbit(intr, poses, frames, XLA_RES, device, dtype=torch.float32,
                              use_pallas=False)
    systems = k2_systems(st, frames[N_FRAMES], intr)
    err, calls, k2_bound = compare_k2(systems)
    print(f"# K2 compare: {len(systems)} systems ({len(systems) - 3} from the warm xla-{XLA_RES} "
          f"pass's last frame, 3 degenerate), max abs err {err}", flush=True)
    from housescan_tpu_torch.kinfu.pipeline import kinfu_step

    _, syncs = host_syncs(lambda: kinfu_step(st, frames[N_FRAMES], intr, use_pallas=False))
    print(f"# xla-{XLA_RES}: one more step made {len(syncs)} host synchronisations", flush=True)
    if syncs:
        fail(f"the XLA step made the host wait on the card at {syncs}")
    del st, systems
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
          f"(warm pass {warm_s:.4f} s); pose error {err_mm:.3f} mm; last rmse "
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
    return dict(err=err, calls=calls, bound=k2_bound, launches=launches, secs=secs)


def main() -> None:
    if not torch.cuda.is_available():
        fail("no CUDA device")
    device = torch.device("cuda")
    card = card_line()
    print(card, flush=True)
    os.makedirs(OUT, exist_ok=True)

    from housescan_tpu_torch.geometry.transform import full_fp32_matmul
    from housescan_tpu_torch.kinfu.pipeline import kinfu_init, kinfu_step
    from housescan_tpu_torch.ops import cuda_lib

    full_fp32_matmul()
    cuda_lib.load()
    ptxas = [ln.strip() for ln in cuda_lib.build_info["ptxas"].splitlines()
             if "registers" in ln or "spill" in ln or "Compiling entry" in ln]
    print(f"# build: {cuda_lib.build_info['seconds']:.1f} s -> {cuda_lib.build_info['path']}", flush=True)
    for ln in ptxas:
        print(f"# ptxas: {ln}", flush=True)

    intr, poses, frames = workload(device)

    # 4. warm orbit, then each kernel against its plain version
    st, warm_s, _ = run_orbit(intr, poses, frames, RES, device)
    st0 = kinfu_init(intr, resolution=RES, size_m=3.0, trunc=0.03, init_pose=poses[0], device=device)
    st0 = kinfu_step(st0, frames[0], intr)
    pose1 = torch.from_numpy(poses[1]).to(device)
    errs, calls, bounds, sizes = compare_kernels(st, st0, intr, frames[N_FRAMES], frames[1], pose1, RES)
    print(f"# compare: max abs err {json.dumps(errs)}", flush=True)
    del st, st0

    # 5. split and unsplit integrates of the orbit
    same, observed = split_orbit_identical(intr, poses, frames, device)
    if not same:
        fail("the orbit integrated with the free split differs from the unsplit one")
    print(f"# split vs unsplit orbit (21 integrates at the true poses): bit-identical, "
          f"{observed} observed voxels", flush=True)

    # 6. the timed main-path run, with launch counts
    cuda_lib.reset_counts()
    st, secs, tracked = run_orbit(intr, poses, frames, RES, device)
    launches = dict(cuda_lib.launch_counts)
    plain = dict(cuda_lib.plain_counts)
    err_mm = float(np.linalg.norm(st.pose[3, :3].cpu().numpy() - poses[N_FRAMES][3, :3])) * 1000.0
    maps = st.model_maps
    print(f"# orbit {RES}^3 {intr.width}x{intr.height}: {N_FRAMES} frames in {secs:.4f} s = "
          f"{secs / N_FRAMES * 1000:.3f} ms/frame = {N_FRAMES / secs:.2f} fps (warm pass "
          f"{warm_s:.4f} s); pose error {err_mm:.3f} mm; last rmse "
          f"{float(st.last_rmse) * 1000:.4f} mm corr {int(st.last_corr)}; "
          f"tracked {sum(tracked)}/{len(tracked)} [{card}]", flush=True)
    print(f"# launches {json.dumps(launches)} plain {json.dumps(plain)}", flush=True)
    if err_mm > POSE_BUDGET_MM:
        fail(f"pose error {err_mm:.3f} mm exceeds {POSE_BUDGET_MM} mm")
    if not all(tracked):
        fail("a frame of the orbit was dropped")
    if tuple(maps.shape) != (8, intr.height, intr.width) or not bool(torch.isfinite(maps).all()):
        fail("model maps malformed")
    if float(maps[7].mean()) < 0.5:
        fail(f"model maps cover only {float(maps[7].mean()):.3f} of the image")
    check_counts("the orbit", launches, plain, cuda_lib.KERNEL_PATH)
    _, syncs = host_syncs(lambda: kinfu_step(st, frames[N_FRAMES], intr))
    print(f"# orbit {RES}^3: one more step made {len(syncs)} host synchronisations {syncs}",
          flush=True)
    del st
    torch.cuda.empty_cache()

    # 7. the scan at full width
    scan_launches = run_scan(intr, poses, frames, card)
    torch.cuda.empty_cache()

    # 8. xla-480: the XLA path's orbit, K2 against its plain version
    xla = run_xla(intr, poses, frames, device, card)
    errs["solve6"], calls["solve6"], bounds["solve6"] = xla["err"], xla["calls"], xla["bound"]
    torch.cuda.empty_cache()

    # 9. scan-480: the scan takes the XLA path unasked
    run_scan(intr, poses, frames, card, res=XLA_RES)
    torch.cuda.empty_cache()

    # 10. kernel vs plain times, CUDA events
    reps = {"bilateral": (50, 3), "icp_level": (20, 2), "tsdf_stream": (5, 1),
            "tsdf_free": (20, 1), "raycast_tiles": (50, 2), "solve6": (200, 3)}
    steps = N_FRAMES + 1
    # launches: the kernel path's from the scan, K2's from the timed xla-480 pass
    path_launches = dict(scan_launches, solve6=xla["launches"]["solve6"])
    step_launches = dict(launches, solve6=xla["launches"]["solve6"])
    rows = []
    for name, (src, replaces) in KERNELS.items():
        k_fn, q_fn = calls[name]
        ms = cuda_ms(k_fn, reps[name][0])
        plain_ms = cuda_ms(q_fn, reps[name][1])
        bound_ms, bound_by = bounds[name]
        print(f"# {name}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bound_ms:.3e} ms "
              f"({bound_by}), {step_launches[name] / steps:.2f} launches/step [{card}]", flush=True)
        rows.append({"name": name, "route": "cuda", "source": src, "replaces": replaces,
                     "launches": path_launches[name], "max_abs_err": errs[name],
                     "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
                     "library_ms": None})
    print(f"# sizes: K4 {sizes['n_listed']} listed chunks, K5 {sizes['n_sb']} superblocks / "
          f"{sizes['n_members']} member chunks", flush=True)
    # the TPU kernels still to port, at their 512^3 shapes: K7 reads the
    # float32 tsdf and weight grids once and writes the (R/8, R/8, R/128,
    # 16, 16) planes, ~30 float ops a voxel (crossing test, moment sums);
    # K8 reads and writes both grids, reads one 640x480 depth frame and
    # writes the (R/8, R/8, 16, 128) planes, ~60 float ops a voxel
    vox = RES ** 3
    k7 = bound(2 * vox * 4 + (RES // 8) ** 2 * (RES // 128) * 256 * 4, 30 * vox)
    k8 = bound(4 * vox * 4 + 640 * 480 * 4 + (RES // 8) ** 2 * 16 * 128 * 4, 60 * vox)
    print(f"# bounds of the kernels still to port at {RES}^3: K7 {k7[0]:.4f} ms ({k7[1]}), "
          f"K8 {k8[0]:.4f} ms ({k8[1]})", flush=True)

    # 11. where the device time goes, on each path
    for tag, res, secs_, kw, name in (
            ("box-512", RES, secs, {}, "profile.txt"),
            (f"xla-{XLA_RES}", XLA_RES, xla["secs"], dict(dtype=torch.float32, use_pallas=False),
             "profile_xla.txt")):
        dev_ms, n_launch, top, stages, k2_us = profile_steps(intr, poses, frames, res, device,
                                                             os.path.join(OUT, name), **kw)
        frame_ms = secs_ / N_FRAMES * 1000.0
        print(f"# profile {tag}: device kernel time {dev_ms:.3f} ms/step in {n_launch:.0f} "
              f"launches/step; timed pass {frame_ms:.3f} ms/frame -> device busy "
              f"{dev_ms / frame_ms * 100:.1f}% [{card}]", flush=True)
        for stage, (d_ms, h_ms) in stages.items():
            print(f"# profile {tag}: stage {stage}: device {d_ms:.3f} ms/step, host {h_ms:.3f} "
                  f"ms/step", flush=True)
        if k2_us is not None:
            print(f"# profile {tag}: K2 solve6_kernel device time {k2_us:.2f} us a launch "
                  f"[{card}]", flush=True)
        for key, ms, n in top:
            print(f"# profile {tag}: {ms:8.4f} ms/step {n:6.1f}x/step {key[:90]}", flush=True)
        torch.cuda.empty_cache()

    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
