#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port's fusion step on one NVIDIA GPU and check it.

Run from the repository root with one CUDA device visible:

    python3 chip_smoke.py

It uses ``housescan_tpu_torch`` only (no JAX) and runs the workload of the
reference bench: the synthetic furnished room, a 21-pose orbit
(``orbit_poses(21, radius=0.25, yaw_range=0.4, pitch=0.25)``), a 512^3
int16-packed volume and 640x480 depth. Phases, each fatal on failure:

  1. a CUDA device must be present;
  2. print the card's name and power limit (nvidia-smi);
  3. build the kernel library from ``housescan_tpu_torch/csrc`` and print
     the build time and the ptxas register/spill lines;
  4. run the orbit once (warm), then compare each kernel (K1 bilateral,
     K3 ICP level, K4 stream integrate, K6 plane raycast) with its plain
     PyTorch version on the card at the shapes that state gives them;
  5. run the orbit again from a fresh state, timed on the host clock
     (frames 1..20 after frame 0, ending in a synchronize), and gate the
     final pose error at the reference bench's 5 mm budget;
  6. require every kernel's launch count from that run to be > 0 and no
     plain version to have run in it;
  7. time each kernel and its plain version with CUDA events;
  8. profile three steps: device kernel time per step against the timed
     pass's frame time (the device's busy share), the top kernels, and the
     full table in ``build/chip_smoke/profile.txt``.

Numbers are printed beside the card's name and power limit. The line
before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

RES = 512
N_FRAMES = 20
POSE_BUDGET_MM = 0.15 * N_FRAMES + 2.0  # bench.py's gate, 5 mm at 20 frames
KERNELS = {
    "bilateral": ("housescan_tpu_torch/csrc/bilateral.cu", "housescan_tpu/ops/preprocess_pallas.py:26"),
    "icp_level": ("housescan_tpu_torch/csrc/icp.cu", "housescan_tpu/ops/icp_pallas.py:51"),
    "tsdf_stream": ("housescan_tpu_torch/csrc/tsdf_stream.cu", "housescan_tpu/ops/tsdf_stream.py:105"),
    "raycast_tiles": ("housescan_tpu_torch/csrc/raycast_tiles.cu", "housescan_tpu/ops/raycast_tiles.py:337"),
}


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


def workload(device):
    from housescan_tpu_torch.kinfu.camera import Intrinsics
    from housescan_tpu_torch.kinfu.synthetic import furnished_room, orbit_poses, render_depth_stream

    intr = Intrinsics(640, 480, 525.0, 525.0, 319.5, 239.5)
    poses = orbit_poses(N_FRAMES + 1, radius=0.25, yaw_range=0.02 * N_FRAMES, pitch=0.25)
    half, boxes = furnished_room()
    frames = render_depth_stream(intr, poses, half, boxes, device=device)
    return intr, poses, frames


def run_orbit(intr, poses, frames, res, device):
    """Fresh state, frame 0, then frames 1..N; returns (state, seconds
    for frames 1..N on the host clock, per-frame tracked flags)."""
    from housescan_tpu_torch.kinfu.pipeline import kinfu_init, kinfu_step

    st = kinfu_init(intr, resolution=res, size_m=3.0, trunc=0.03, init_pose=poses[0], device=device)
    st = kinfu_step(st, frames[0], intr)
    torch.cuda.synchronize()
    tracked = []
    t0 = time.perf_counter()
    for i in range(1, len(frames)):
        st = kinfu_step(st, frames[i], intr)
        tracked.append(st.last_tracked)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    return st, seconds, [bool(t) for t in tracked]


def compare_kernels(st, intr, depth, res):
    """Each kernel against its plain version at the main path's shapes,
    from the state after the warm orbit. Returns per-kernel max abs error
    and the callables the timing phase reuses."""
    from housescan_tpu_torch.kinfu import maps as mp
    from housescan_tpu_torch.kinfu.preprocess import build_pyramid
    from housescan_tpu_torch.ops.chunk_select import build_worklist
    from housescan_tpu_torch.ops.icp_cuda import BAND_H, icp_level, icp_level_plain
    from housescan_tpu_torch.ops.preprocess_cuda import bilateral_filter_cuda, bilateral_filter_plain
    from housescan_tpu_torch.ops.raycast_tiles import (
        _ray_params, build_tile_candidates, launch_raycast_kernel, raycast_tiles_plain,
    )
    from housescan_tpu_torch.ops.tsdf_stream import (
        FIELD_SAT, _stream_params, build_depth_mips, integrate_plain, launch_stream_kernel,
    )

    errs, calls = {}, {}

    # K1
    k = bilateral_filter_cuda(depth)
    q = bilateral_filter_plain(depth)
    errs["bilateral"] = float((k - q).abs().max())
    if errs["bilateral"] > 2e-5:
        fail(f"K1 bilateral differs from its plain version by {errs['bilateral']}")
    calls["bilateral"] = (lambda: bilateral_filter_cuda(depth), lambda: bilateral_filter_plain(depth))

    # K3 at the finest level, with the step's level-0 arguments
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

    # K4 on copies of the volume, the same work list for both
    vol, planes, pose = st.volume, st.planes, st.pose
    sat = planes[:, :, :, FIELD_SAT, :4].reshape(-1, 4) > 0.5
    wl = build_worklist(depth, pose, intr, vol.dims, vol.voxel_size, vol.origin, vol.trunc, sat_quarters=sat)
    mips = build_depth_mips(depth)
    params = _stream_params(vol, pose, intr, 128.0, res // 8, res // 128)
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
    print(f"# K4 compare: {n_listed} listed chunks, plane field max diff {fdiff}", flush=True)
    scratch = vol.data.clone(), planes.clone()
    calls["tsdf_stream"] = (
        lambda: launch_stream_kernel(scratch[0], scratch[1], wl.desc, wl.count, mips, params),
        lambda: integrate_plain(scratch[0], scratch[1], wl.desc, wl.count, mips, params,
                                res // 8, res // 128),
    )

    # K6 on the state's planes at its pose
    cand = build_tile_candidates(planes, pose, intr, vol)
    n_ut = -(-intr.width // 128)
    rparams = _ray_params(pose, intr, 0.3, n_ut)
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
    return errs, calls


def profile_steps(intr, poses, frames, res, device, out_path, n=3):
    """Device kernel time per step over ``n`` steps of a fresh orbit, and
    the top kernels; the full table goes to ``out_path``."""
    from torch.profiler import ProfilerActivity, profile

    from housescan_tpu_torch.kinfu.pipeline import kinfu_init, kinfu_step

    st = kinfu_init(intr, resolution=res, size_m=3.0, trunc=0.03, init_pose=poses[0], device=device)
    for i in range(3):
        st = kinfu_step(st, frames[i], intr)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for i in range(3, 3 + n):
            st = kinfu_step(st, frames[i], intr)
        torch.cuda.synchronize()
    avgs = prof.key_averages()
    # named self_device_time_total in newer PyTorch, self_cuda_time_total before
    attr = "self_device_time_total" if hasattr(avgs[0], "self_device_time_total") else "self_cuda_time_total"
    kernels = [e for e in avgs if e.device_type == torch.autograd.DeviceType.CUDA]
    dev_ms = sum(getattr(e, attr) for e in kernels) / 1000.0 / n
    launches = sum(e.count for e in kernels) / n
    os.makedirs(os.path.dirname(out_path), exist_ok=True)
    with open(out_path, "w") as f:
        f.write(avgs.table(sort_by=attr, row_limit=60))
    top = sorted(kernels, key=lambda e: -getattr(e, attr))[:10]
    return dev_ms, launches, [(e.key, getattr(e, attr) / 1000.0 / n, e.count / n) for e in top]


def main() -> None:
    if not torch.cuda.is_available():
        fail("no CUDA device")
    device = torch.device("cuda")
    card = card_line()
    print(card, flush=True)

    from housescan_tpu_torch.geometry.transform import full_fp32_matmul
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
    errs, calls = compare_kernels(st, intr, frames[N_FRAMES], RES)
    print(f"# compare: max abs err {json.dumps(errs)}", flush=True)
    del st

    # 5-6. the timed main-path run, with launch counts
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
    if any(launches[k] <= 0 for k in KERNELS) or any(plain[k] for k in KERNELS):
        fail("the main path did not go through every kernel")

    # 7. kernel vs plain times, CUDA events
    reps = {"bilateral": (50, 3), "icp_level": (20, 2), "tsdf_stream": (5, 1), "raycast_tiles": (50, 2)}
    rows = []
    for name, (src, replaces) in KERNELS.items():
        k_fn, q_fn = calls[name]
        ms = cuda_ms(k_fn, reps[name][0])
        plain_ms = cuda_ms(q_fn, reps[name][1])
        print(f"# {name}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms [{card}]", flush=True)
        rows.append({"name": name, "route": "cuda", "source": src, "replaces": replaces,
                     "launches": launches[name], "max_abs_err": errs[name],
                     "ms": ms, "plain_ms": plain_ms})

    # 8. where the device time goes
    dev_ms, n_launch, top = profile_steps(intr, poses, frames, RES, device, "build/chip_smoke/profile.txt")
    frame_ms = secs / N_FRAMES * 1000.0
    print(f"# profile: device kernel time {dev_ms:.3f} ms/step in {n_launch:.0f} launches/step; "
          f"timed pass {frame_ms:.3f} ms/frame -> device busy {dev_ms / frame_ms * 100:.1f}% [{card}]",
          flush=True)
    for key, ms, n in top:
        print(f"# profile: {ms:8.4f} ms/step {n:6.1f}x/step {key[:90]}", flush=True)

    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
