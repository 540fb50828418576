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
float32 volume. Phases, each fatal on failure (numbers 6 and 13 are
not used, so that the others keep the numbers the project's records
cite):

  1. a CUDA device must be present;
  2. print the card's name and power limit (nvidia-smi);
  3. build the kernel library from ``housescan_tpu_torch/csrc`` (one nvcc
     per source, in parallel) and print the build time and the ptxas
     register/spill lines;
  4. box-512 (packed): run the fusion orbit once from a fresh state and
     gate it: the final pose error within the reference bench's 5 mm
     budget, every frame tracked, the model maps finite and covering half
     the image, every kernel of the path launched in it and no plain
     version run, and one more step (on copies of the volume and planes)
     making the host wait on the card nowhere (PyTorch's sync debug
     mode); then compare each kernel (K1 bilateral, K11 pyramid, K3 ICP level, K4
     stream integrate, K5 free carve, K6 plane raycast, K9 work-list
     prepass, K10 marching tetrahedra on the warm volume, bit-identical)
     with its plain PyTorch version on the card at the shapes the main
     path gives it; K5 on a free list of at least
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
  7. box-512-f32: phases 4-5 on the float32 volume: the orbit with phase
     4's gates, K4 and K5 against their plain versions on the float
     layout, split against unsplit bit-identical, K7 as the oracle of K4's
     persistent planes (a fresh extraction after a step equals them on
     every listed chunk: valid flags identical, fields but 11 within 1e-5
     where valid), K4 and K5 on the empty list;
  8. the scan at full width: record the 21 frames, load them, and run
     ``scan_to_room_dir(config=Config(), write_mesh=True)`` (the kernel
     path, fusing into float32) into ``build/chip_smoke/scan_room``; the
     kernel launch counts of this run must show every kernel of the kernel
     path and no plain version; gate on no dropped frame, every
     reference-layout file present and parsing, >= 2 planes and a
     non-empty mesh inside the volume; print the pose error; K10 against
     its plain version on the card on the float32 volume the scan meshed
     (the main path's layout and shape: bit-identical, one K10 call and no
     plain one, timed as phase 4 times it);
  9. xla-480: the orbit on the XLA path with launch counts: pose error <=
     5 mm, 20/20 tracked, model-map coverage >= 0.5, K1 and K2 launched,
     K3-K8 not, no plain version; print the peak memory; then K2 (the
     standalone solve) against its plain version on the card on the
     (A, b, pose) of real iterations of that orbit's last frame and on
     degenerate systems (bit-identical), its device time a call beside an
     empty one-thread kernel's (the latency floor), and one more step
     that must not make the host wait on the card;
 10. scan-480: ``scan_to_room_dir`` at ``Config()`` with a 480^3 volume,
     which takes the XLA path unasked, into
     ``build/chip_smoke/scan_room_480``, with phase 8's gates, K10 on its
     480^3 volume, and launch counts showing K1 and K2 and no plain
     version;
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
 14. curved-512 and noisy-512: the bench orbit on the kernel path at
     box-512's setup in the curved world (spheres, a capped cylinder,
     yaw-rotated boxes), and in the box world with 2 mm depth noise
     (seed 0) rounded through uint16 millimetres; each from a fresh
     packed volume with the counts set to 0: every kernel of the path
     launched, no plain version, no frame dropped, the pose error within
     bench.py's budget (12.5 and 11.0 mm), no host synchronisation in one
     more step; K1, K3, K4, K5 and K6 against their plain versions on its
     last frame with phase 4's bounds;
 15. rooms: two rooms scanned by ``scan_to_room_dir`` at ``Config()``
     (512^3 float32, 640x480, 32 known poses each, as
     tests/test_end_to_end.py sweeps them) into ``build/chip_smoke/rooms``,
     then the room stage with every scene on the card: load, corners,
     cuboid fit, a room moved, walls connected, positions optimised,
     .xf files and placed full-resolution clouds, with that test's
     assertions; then the same on the CPU from the same directories, the
     card held to it (corners 1e-4 m, rmse 1e-5, positions 1e-4 m, .xf
     1e-5);
 16. box-512-bf16: the kernel path on a fresh (2, 512, 512, 512) bfloat16
     volume: the orbit with phase 4's gates, K4 and K5 against their plain
     versions (bit-identical) and on the empty list, K7 as the oracle of K4's
     planes and against its plain version (bit-identical, its bound from
     the data: 2 bytes a weight and an observed tsdf), split against
     unsplit bit-identical, the full-width twin of the reference's
     test_bf16_parity_with_f32 (frame 0 against a float32 volume: weights
     identical, |dt| < 5e-4 where |t| < 0.1, < 4.5e-3 wherever observed);
     K4, K5 and K7 timed beside their float32 times of phase 12;
 17. sharded-512: ``make_sharded_step(use_pallas=True)`` on
     ``make_mesh(4, devices=[cuda:0] * 4)``, a packed 512^3 volume as 4
     X-slabs of 128 x 512 x 512: frames 0-2 teacher-forced from the
     single-device state (pose, volume, planes, model vertices, valid mask
     bit-identical; normals < 5e-3 with under 1% of pixels over 1e-4),
     then the orbit free from a fresh state (pose error <= 5 mm and within
     2 mm of box-512's final position; K1 and K3 launched, K4, K5 and K6
     four times a step, no plain version, no host synchronisation in one
     more step); then the XLA path on 4 slabs at 480^3:
     frame 0's integrate bit-identical to the single-device one, frames 1
     and 2 tracked (pose within 2.5 mm, half a frame's motion);
 18. building: ``scan_building`` at ``Config()`` over two rooms (phase
     15's 32 known poses each) with no mesh and on the 4-slab mesh of this
     card (the sharded route and ``fit_cuboids_sharded``), each into
     ``build/chip_smoke/building_<route>``, with tests/test_building.py's
     end-to-end assertions; both routes finish the same rooms with the
     same wall connections and place them within 2 mm (``run_building``
     derives the bound);
 19. cli: the command line (``housescan_tpu_torch.cli.main``) in this
     process, every command's last output lines printed, its outputs in
     ``build/chip_smoke/cli``: the bench orbit recorded as uint16 mm;
     ``scan --mesh --checkpoint-every 10`` at ``Config()`` (512^3, from
     the identity pose, as the command line starts): K1 and K3-K6
     launched and no plain version, the trajectory equal to
     ``scan_to_room_dir``'s with the same arguments (``run_cli`` says why
     not the 5 mm budget), the room directory loading, then ``--resume``
     reproducing the trajectory; ``scan --live`` over ``HOUSESCAN_FAKE_DEVICE`` = the
     recording, unpaced and paced (``--realtime``): the source opened,
     every frame read fused (the frames matched to the recording) and the
     trajectory equal to ``scan_to_room_dir``'s on the frames read; the
     room stage on the scanned room and
     phase 15's two rooms (``add-room``, ``suggest``, ``accept-corner``
     where needed, ``fit-cuboid``, ``auto-align``, ``move``, ``connect``,
     ``optimize``, ``export --full-res``, ``render``, ``info``), the scene
     round-tripping, the .xf files parsing, the image not empty;
     ``detect-planes``;
     ``scan-building --sharded --known-poses`` over phase 18's rooms on
     the visible cards; ``refuse --devices 2x2`` with ``--device
     cuda:0``; two steps under ``utils.metrics.device_trace`` (the trace
     names K1 and K3-K6; ``tsdf_occupancy`` equals a CPU count);
     ``store_state``, ``reload_framework``, ``get_state`` and the step
     after the reload bit-identical to the one before; then
     ``dryrun_multichip(4, device="cuda:0")``.

``python3 chip_smoke.py --mesh`` runs phases 1-3, then K10 (the scan's
marching-tetrahedra mesh) against its plain version on the card and
timed: on box-512's warm orbit volume in each layout (packed, float32,
bfloat16) and on a 1024^3 float32 volume over 6 m holding the
room-scan traffic's room fused at its 21 true poses (the room cell's
shape, which the whole run does not reach); each with its triangles,
its three kernels' device time, the call's host time, the plain
version's, the bound and the host waits, then its resident blocks an
SM.

``python3 chip_smoke.py --probe`` runs phases 1-4, phase 7's K4 and K5
comparisons and empty lists, phase 12's times of the main path's kernels
(K1, K11, K3-K6) and of K7 on box-512's packed volume, with K1's device time
and estimated issue floor, K8 on dense-512's compare input and K7 on the
orbit fused by K8 (phase 11's comparisons and readings, the render's
time, phase 12's times), every kernel's resident blocks an SM, then K2
on the systems of box-512's warm state (phase 9's comparison and
readings, timed), and prints no result
line. Copied into a checkout of an earlier commit whose package has
every kernel it calls (K1-K11), it reads the same calls there: the
before and after of a redesign, in turns within one run on the card.

Numbers are printed beside the card's name and power limit. The line
before the last is the kernels' JSON record (launches: each kernel's
path's run: the scan's for the kernel path, the xla-480 orbit for K2,
the dense-512 run for K7 and K8; ``launches_sharded``: the free
sharded-512 run's; ``launches_cli``: phase 19's; the rows ``...@bf16``:
K4 and K5 on box-512-bf16's orbit, K7 in its oracle run); the last
line is ``{"ok": true,
"device": {...}}``.
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
    "planes_extract": ("housescan_tpu_torch/csrc/planes_extract.cu",
                       "housescan_tpu/ops/planes_pallas.py:372"),
    "tsdf_dense": ("housescan_tpu_torch/csrc/tsdf_dense.cu", "housescan_tpu/ops/tsdf_pallas.py:53"),
    # no Pallas kernel: the reference's prepass is XLA array code
    "chunk_select": ("housescan_tpu_torch/csrc/chunk_select.cu",
                     "none (XLA code: housescan_tpu/ops/chunk_select.py:207)"),
    # no Pallas kernel: the reference's mesh is XLA array code too
    "marching_tets": ("housescan_tpu_torch/csrc/marching_tets.cu",
                      "none (XLA code: housescan_tpu/kinfu/marching_cubes.py:363)"),
    # no Pallas kernel: the reference's pyramid is XLA array code too
    "pyramid": ("housescan_tpu_torch/csrc/pyramid.cu",
                "none (XLA code: housescan_tpu/kinfu/preprocess.py:228)"),
}
HBM_BYTES_PER_S = 3.35e12  # H100 SXM
F32_OPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores
QUEUE_CYCLES = 50_000_000  # ~25 ms of device clock: cuda_ms's head start for the host
CHUNK_VOXELS = 8 * 8 * 128
TILE_BYTES = 16 * 16 * 4  # one chunk's planes tile
LAYOUTS = {torch.int32: "packed", torch.float32: "float32", torch.bfloat16: "bfloat16"}
TAGS = {torch.int32: "", torch.float32: "-f32", torch.bfloat16: "-bf16"}  # box-512's cell names
SMALL_CAM = (160, 120, 131.25, 131.25, 79.5, 59.5)  # the reference tests' 160x120 camera
SMALL_K6 = "raycast_tiles@160x120"  # K6 at SMALL_CAM: 30 tiles, 384 candidates a tile
PACKED_K7 = f"planes_extract@box-{RES}"  # K7 on box-512's packed volume after its warm orbit


def chunk_bytes(data) -> int:
    """Bytes of one (8, 8, 128) chunk of the volume's layout: 4 a voxel
    packed and bfloat16, 8 float32."""
    return CHUNK_VOXELS * (4 if data.dim() == 3 else 2 * data.element_size())


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
    """Fresh state, frame 0, then frames 1..N; returns (state, per-frame
    tracked flags of frames 1..N)."""
    from housescan_tpu_torch.kinfu.pipeline import kinfu_init, kinfu_step

    st = kinfu_init(intr, resolution=res, size_m=3.0, trunc=0.03, init_pose=poses[0], dtype=dtype,
                    device=device)
    st = kinfu_step(st, frames[0], intr, use_pallas=use_pallas)
    tracked = []
    for i in range(1, len(frames)):
        st = kinfu_step(st, frames[i], intr, use_pallas=use_pallas)
        tracked.append(st.last_tracked)
    return st, [bool(t) for t in tracked]


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
    from housescan_tpu_torch.ops.pyramid_cuda import pyramid_cuda, pyramid_plain

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

    # K11 from K1's output: every level's depth and map rows bit for bit
    # (signed zeros too); the filtered depth read once, each output written
    # once, ~60 float ops a map pixel
    kd, km = pyramid_cuda(k, intr)
    qd, qm = pyramid_plain(k, intr)
    errs["pyramid"] = max(float((a - b).abs().max()) for a, b in zip(kd + km, qd + qm))
    if not all(torch.equal(a.view(torch.int32), b.view(torch.int32))
               for a, b in zip(kd + km, qd + qm)):
        fail(f"K11 pyramid differs from its plain version by {errs['pyramid']} (0 bits required)")
    calls["pyramid"] = (lambda: pyramid_cuda(k, intr), lambda: pyramid_plain(k, intr))
    bounds["pyramid"] = bound(4 * (h * w + sum(t.numel() for t in kd[1:] + km)),
                              60 * sum(m[0].numel() for m in km))

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
    errs["chunk_select"], calls["chunk_select"], bounds["chunk_select"] = \
        compare_chunk_select(st, depth, intr)
    errs["marching_tets"], calls["marching_tets"], bounds["marching_tets"] = \
        compare_mesh(st.volume, f"box-{RES} packed", card)

    # K6 at the main path's 640x480 (96 candidates a tile) and, on the same
    # planes, at 160x120 (fewer than 128 tiles: 384 a tile)
    for cam, key in ((intr, "raycast_tiles"), (Intrinsics(*SMALL_CAM), SMALL_K6)):
        errs[key], calls[key], bounds[key] = compare_raycast(st, cam, card)
    return errs, calls, bounds, dict(n_listed=n_listed, n_sb=n_sb, n_members=n_members)


def compare_chunk_select(st, depth, intr):
    """K9 against its plain version on the state's planes at its pose:
    every row of the work list, its count and every field of the free list
    bit-identical. Returns (0.0, timing calls, bound). Bound: the depth
    image and each chunk's five flags of planes field 11 read once, the
    work list (32 bytes a chunk) and the free list (16 bytes a superblock)
    written once; ~1,000 float ops a chunk (40 corner projections, four
    footprint look-ups) and 4 a pixel."""
    from housescan_tpu_torch.ops.chunk_select import build_worklist, launch_chunk_select
    from housescan_tpu_torch.ops.tsdf_stream import FIELD_SAT, N_QUARTERS

    vol, planes, pose = st.volume, st.planes, st.pose
    wl, fwl, params, _, _ = free_inputs(vol, planes, depth, pose, intr)
    kwl, kfwl = launch_chunk_select(depth, planes, params, intr, vol.dims, True)
    torch.cuda.synchronize()
    if not (torch.equal(kwl.desc, wl.desc) and torch.equal(kwl.count, wl.count)
            and all(torch.equal(a, b) for a, b in zip(kfwl, fwl))):
        fail("K9 chunk_select differs from its plain version (bit-identical required)")
    n, n_sb = wl.desc.shape[0], fwl.bitmap.shape[0]
    print(f"# K9 compare: {int(wl.count[0])} of {n} chunks listed, {int(fwl.count[0])} of {n_sb} "
          "superblocks, bit-identical", flush=True)

    def plain():
        sat = planes[:, :, :, FIELD_SAT, :N_QUARTERS].reshape(-1, N_QUARTERS) > 0.5
        neg = planes[:, :, :, FIELD_SAT, N_QUARTERS].reshape(-1) > 0.5
        return build_worklist(depth, pose, intr, vol.dims, vol.voxel_size, vol.origin, vol.trunc,
                              sat_quarters=sat, neg_flags=neg, free_split=True)

    calls = (lambda: launch_chunk_select(depth, planes, params, intr, vol.dims, True), plain)
    n_bytes = depth.numel() * 4 + n * (5 * 4 + 32) + n_sb * 16
    return 0.0, calls, bound(n_bytes, 1000 * n + 4 * depth.numel())


def compare_mesh(vol, tag, card, reps=5):
    """K10 against its plain version (on the card) on ``vol``: the same
    vertex bytes, faces and count, one K10 call and no plain one. Prints
    the triangles, K10's three kernels' device time (the profiler), the
    call's host ms (to the Mesh on the host), the plain version's host ms,
    the bound and where the call made the host wait. Returns (0.0, timing
    calls, bound). Bound: every cell of the volume read once (8 bytes
    float32, 4 packed and bfloat16) and the triangles written once (36
    bytes each); ~40 float ops a cell and ~250 a triangle."""
    from housescan_tpu_torch.kinfu.marching_cubes import marching_cubes, marching_cubes_plain
    from housescan_tpu_torch.ops import cuda_lib

    launched, plain = cuda_lib.launch_counts["marching_tets"], cuda_lib.plain_counts["marching_tets"]
    got = marching_cubes(vol)
    if (cuda_lib.launch_counts["marching_tets"] - launched,
            cuda_lib.plain_counts["marching_tets"] - plain) != (1, 0):
        fail(f"{tag}: marching_cubes on the card did not make exactly one K10 call")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want = marching_cubes_plain(vol)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    if got.vertices.tobytes() != want.vertices.tobytes() or \
            not np.array_equal(got.faces, want.faces):
        fail(f"K10 marching_tets differs from its plain version on {tag} "
             f"({len(got.faces)} vs {len(want.faces)} triangles; bit-identical required)")
    n = len(got.faces)
    del want
    cells = int(np.prod(vol.dims))
    n_bytes = cells * (4 if vol.data.dim() == 3 else 2 * vol.data.element_size()) + 36 * n
    b = bound(n_bytes, 40 * cells + 250 * n)
    dev_us = kernel_device_us(lambda: marching_cubes(vol), reps)
    k10_ms = sum(us for k, (us, _) in dev_us.items() if k.startswith("void mt_")
                 or k.startswith("mt_")) / 1e3
    kernels = {k.split("<")[0].replace("void ", ""): round(us / 1e3, 4)
               for k, (us, _) in dev_us.items() if "mt_" in k}
    host = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        marching_cubes(vol)
        host.append((time.perf_counter() - t0) * 1e3)
    _, syncs = host_syncs(lambda: marching_cubes(vol))
    # the call's second wait alone: n triangles copied to pinned memory
    tris, pinned = torch.empty((n, 9), device=vol.data.device), torch.empty((n, 9), pin_memory=True)
    copy = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pinned.copy_(tris)
        copy.append((time.perf_counter() - t0) * 1e3)
    del tris, pinned
    print(f"# K10 compare ({tag}, {vol.dims}): {n} triangles, bit-identical; kernels "
          f"{k10_ms:.4f} ms device {json.dumps(kernels)}; the call {np.median(host):.3f} ms host "
          f"(median of {reps}, to the Mesh; its copy to pinned memory {np.median(copy):.3f} ms); "
          f"plain {plain_ms:.1f} ms host; bound {b[0]:.4f} ms ({b[1]}; {n_bytes / 1e9:.3f} GB); "
          f"host waits {syncs} [{card}]", flush=True)
    return 0.0, (lambda: marching_cubes(vol), lambda: marching_cubes_plain(vol)), b


def room_volume(intr, device, res=1024):
    """The room-scan traffic's room (the furnished room and its furniture
    stretched x2 in x and z) fused at its 21 true orbit poses, without
    noise, into a res^3 float32 volume over 6 m by the kernel path's
    integrate."""
    from housescan_tpu_torch.kinfu.synthetic import furnished_room, orbit_poses, render_depth_stream
    from housescan_tpu_torch.kinfu.tsdf import tsdf_new
    from housescan_tpu_torch.ops.tsdf_stream import planes_shape, tsdf_integrate_stream

    half, boxes = furnished_room()
    half, boxes = half.copy(), boxes.copy()
    half[[0, 2]] *= 2.0
    boxes[:, :, [0, 2]] *= 2.0
    poses = orbit_poses(N_FRAMES + 1, radius=0.25, yaw_range=0.4, pitch=0.25)
    frames = render_depth_stream(intr, poses, half, boxes, device=device)
    vol = tsdf_new(res, 6.0, 0.03, device=device)
    planes = torch.zeros(planes_shape(res), device=device)
    for d, p in zip(frames, poses):
        tsdf_integrate_stream(vol, planes, d, torch.from_numpy(p).to(device), intr)
    del planes, frames
    return vol


def mesh_probe(intr, poses, frames, device, card):
    """``--mesh``: K10 against its plain version and timed (``compare_mesh``,
    then phase 12's CUDA-event times) on box-512's warm orbit volume in
    each layout and on the 1024^3 room volume; K10's resident blocks an
    SM."""
    from housescan_tpu_torch.ops import cuda_lib

    calls, bounds = {}, {}
    for dtype in (torch.int32, torch.float32, torch.bfloat16):
        st, _ = run_orbit(intr, poses, frames, RES, device, dtype=dtype)
        name = f"marching_tets@box-{RES}{TAGS[dtype]}"
        _, calls[name], bounds[name] = compare_mesh(st.volume, f"box-{RES} {LAYOUTS[dtype]}", card)
        REPS[name] = REPS["marching_tets"]
        time_kernels([name], calls, bounds, card)
        del st, calls[name]
        torch.cuda.empty_cache()
    vol = room_volume(intr, device)
    name = "marching_tets@room-1024"
    _, calls[name], bounds[name] = compare_mesh(vol, "room-1024 float32", card)
    REPS[name] = (REPS["marching_tets"][0], 1)
    time_kernels([name], calls, bounds, card)
    print(f"# K10 resident blocks an SM: {json.dumps(cuda_lib.occupancy('marching_tets'))} "
          f"[{card}]", flush=True)


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
    if kd.dtype == torch.bfloat16 and not (torch.equal(kd, qd) and torch.equal(kpl, qpl)):
        fail(f"K4 ({tag}) volume or planes differ from the plain version (bit-identical required)")
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
    # words of the volume the carve changes (packed cells, or the tsdf and
    # weight cells of the planes, 4 or 2 bytes), compared as bits
    word = vol.data.element_size()
    as_bits = {4: torch.int32, 2: torch.int16}[word]
    words = int((kd.view(as_bits) != vol.data.view(as_bits)).sum())
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
    return 0.0, calls, bound(n_members * (chunk_bytes(vol.data) + TILE_BYTES) + word * words,
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
    # the layout the scan fuses into, read from the state it creates
    init, layouts = scan.kinfu_init, []

    def recording_init(*args, **kwargs):
        state = init(*args, **kwargs)
        layouts.append((state.volume.data.dtype, tuple(state.volume.data.shape)))
        return state

    # and the volume it meshes, for K10's comparison after the scan
    mesh_fn, meshed = scan.marching_cubes, []

    def recording_mesh(volume, *args, **kwargs):
        meshed.append(volume)
        return mesh_fn(volume, *args, **kwargs)

    scan.kinfu_init, scan.marching_cubes = recording_init, recording_mesh
    cuda_lib.reset_counts()
    try:
        scan.scan_to_room_dir(stream, room, config=cfg, init_pose=poses[0], write_mesh=True)
    finally:
        scan.kinfu_init, scan.marching_cubes = init, mesh_fn
    if layouts != [(torch.float32, (2, res, res, res))]:
        fail(f"the scan at {res}^3 fused into {layouts}, not the float32 volume")
    launches, plain = dict(cuda_lib.launch_counts), dict(cuda_lib.plain_counts)
    tag = "kernel path" if kernel_path else "XLA path"
    print(f"# scan {res}^3 ({tag}) launches {json.dumps(launches)} plain {json.dumps(plain)}",
          flush=True)
    check_counts(f"the scan at {res}^3", launches, plain,
                 (cuda_lib.KERNEL_PATH if kernel_path else cuda_lib.XLA_PATH) + ("marching_tets",))

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
    if len(meshed) != 1:
        fail(f"the scan at {res}^3 meshed {len(meshed)} volumes, not 1")
    compare_mesh(meshed.pop(), f"scan {res}^3 float32", card)
    return launches


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
    """Phase 9, xla-480: the orbit with launch counts and its gates, then
    K2 against its plain version on systems of the orbit's last frame, and
    one more step that must not make the host wait on the card."""
    from housescan_tpu_torch.kinfu.pipeline import kinfu_step
    from housescan_tpu_torch.ops import cuda_lib

    torch.cuda.reset_peak_memory_stats()
    cuda_lib.reset_counts()
    st, tracked = run_orbit(intr, poses, frames, XLA_RES, device, dtype=torch.float32,
                            use_pallas=False)
    launches, plain = dict(cuda_lib.launch_counts), dict(cuda_lib.plain_counts)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    err_mm = float(np.linalg.norm(st.pose[3, :3].cpu().numpy() - poses[N_FRAMES][3, :3])) * 1000.0
    cover = float(st.model_maps[7].mean())
    print(f"# xla-{XLA_RES} {intr.width}x{intr.height} float32 (use_pallas=False): {N_FRAMES} "
          f"frames; pose error {err_mm:.3f} mm; last rmse {float(st.last_rmse) * 1000:.4f} mm "
          f"corr {int(st.last_corr)}; tracked "
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
    print(f"# K2 compare: {len(systems)} systems ({len(systems) - 3} from the xla-{XLA_RES} "
          f"orbit's last frame, 3 degenerate), bit-identical", flush=True)
    k2_readings(calls, card)
    _, syncs = host_syncs(lambda: kinfu_step(st, frames[N_FRAMES], intr, use_pallas=False))
    print(f"# xla-{XLA_RES}: one more step made {len(syncs)} host synchronisations", flush=True)
    if syncs:
        fail(f"the XLA step made the host wait on the card at {syncs}")
    return dict(err=err, calls=calls, bound=k2_bound, launches=launches)


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
    # the least bytes: float32 (bfloat16), every weight and the tsdf of the
    # observed voxels, 4 (2) bytes each (an unobserved voxel reads no
    # neighbour and adds no term); packed, every cell (both values in one
    # word); the planes written. ~30 float ops an observed voxel (crossing
    # tests, moment terms)
    packed = vol.data.dim() == 3
    cell = vol.data.element_size()
    need = cell * voxels + (0 if packed else cell * observed) + out_bytes
    tight = bound(need, 30 * observed)
    loose = bound((cell if packed else 2 * cell) * voxels + out_bytes, 30 * voxels)
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
    vol = fresh()
    for d, p in zip(frames, pose_t):
        vol, _ = tsdf_integrate_with_planes(vol, d, p, intr)
    maps = {k: raycast_pallas(vol, pose_t[k], intr) for k in (N_FRAMES, 0)}
    torch.cuda.synchronize()
    launches, plain = dict(cuda_lib.launch_counts), dict(cuda_lib.plain_counts)
    print(f"# {tag}: {N_FRAMES + 1} frames fused by K8 [{card}]", flush=True)
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
        "planes_extract": (20, 1), PACKED_K7: (20, 1), "tsdf_dense": (10, 1),
        "chunk_select": (50, 3), "marching_tets": (10, 1), "pyramid": (50, 3)}


def warm_states(intr, poses, frames, device, dtype, card):
    """(the state after the orbit on a fresh ``dtype`` volume, the state
    after frame 0 alone, the orbit's launches). The orbit's gates: the
    volume's layout, the final pose error within POSE_BUDGET_MM, every
    frame tracked, the model maps' shape, finiteness and coverage, every
    kernel of the path launched and no plain version run, and one more
    step (on copies of the volume and planes, which the comparisons
    read next) that must not make the host wait on the card."""
    from housescan_tpu_torch.kinfu.pipeline import kinfu_init, kinfu_step
    from housescan_tpu_torch.ops import cuda_lib

    tag = f"box-{RES}" + TAGS[dtype]
    cuda_lib.reset_counts()
    st, tracked = run_orbit(intr, poses, frames, RES, device, dtype=dtype)
    launches, plain = dict(cuda_lib.launch_counts), dict(cuda_lib.plain_counts)
    err_mm = float(np.linalg.norm(st.pose[3, :3].cpu().numpy() - poses[N_FRAMES][3, :3])) * 1000.0
    maps = st.model_maps
    cover = float(maps[7].mean())
    print(f"# {tag} {intr.width}x{intr.height} ({LAYOUTS[dtype]} volume "
          f"{tuple(st.volume.data.shape)}): {N_FRAMES} frames; pose error {err_mm:.3f} mm; "
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
    copy = st._replace(volume=st.volume._replace(data=st.volume.data.clone()),
                       planes=st.planes.clone())
    _, syncs = host_syncs(lambda: kinfu_step(copy, frames[N_FRAMES], intr))
    del copy
    print(f"# {tag}: one more step made {len(syncs)} host synchronisations {syncs}", flush=True)
    if syncs:
        fail(f"the {tag} step made the host wait on the card at {syncs}")
    st0 = kinfu_init(intr, resolution=RES, size_m=3.0, trunc=0.03, init_pose=poses[0],
                     dtype=dtype, device=device)
    return st, kinfu_step(st0, frames[0], intr), launches


def box_kernels(intr, poses, frames, device, card):
    """Phase 4 on the packed volume: the gated orbit (``warm_states``),
    then each main-path kernel against its plain version, K7 on the warm
    state's volume, K3's level calls and K4 on an empty list. Returns
    (errors, timing calls, bounds, list sizes, the warm state)."""
    pose1 = torch.from_numpy(poses[1]).to(device)
    st, st0, _ = warm_states(intr, poses, frames, device, torch.int32, card)
    errs, calls, bounds, sizes = compare_kernels(st, st0, intr, frames[N_FRAMES], frames[1], pose1,
                                                 card)
    errs[PACKED_K7], calls[PACKED_K7], bounds[PACKED_K7] = compare_extract(
        st.volume, f"box-{RES} packed", card)
    print(f"# compare: max abs err {json.dumps(errs)}", flush=True)
    icp_levels(st, frames[N_FRAMES], intr, card)
    stream_empty_list(st, frames[N_FRAMES], intr, card)
    return errs, calls, bounds, sizes, st


def f32_kernels(intr, poses, frames, device, card):
    """Phase 7's kernels on the float32 volume: the gated orbit
    (``warm_states``), K4 and K5 against their plain versions, K4 on an
    empty list. Returns ({kernel: its compare_* result}, the warm
    state)."""
    pose1 = torch.from_numpy(poses[1]).to(device)
    st, st0, _ = warm_states(intr, poses, frames, device, torch.float32, card)
    f32 = {"tsdf_stream": compare_stream(st, frames[N_FRAMES], intr),
           "tsdf_free": compare_free(st, st0, frames[N_FRAMES], frames[1], pose1, intr,
                                         card)}
    stream_empty_list(st, frames[N_FRAMES], intr, card)
    return f32, st


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


def time_f32(f32, card, layout="float32"):
    """Phase 12 for K4 and K5 on the float32 volume (phase 16: on the
    bfloat16 one). Returns {kernel: (ms, plain ms, bound ms, bound by)}."""
    out = {}
    cell = f"box-{RES}" + ("-f32" if layout == "float32" else "-bf16")
    for name, (err, (k_fn, q_fn), (bound_ms, bound_by), *_) in f32.items():
        ms = cuda_ms(k_fn, REPS[name.split("@")[0]][0])
        plain_ms = cuda_ms(q_fn, REPS[name.split("@")[0]][1])
        out[name] = (ms, plain_ms, bound_ms, bound_by)
        print(f"# {name} ({layout} volume, {cell}): kernel {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms, bound {bound_ms:.3e} ms ({bound_by}), max abs err {err} "
              f"[{card}]", flush=True)
    return out


def probe(intr, poses, frames, device, card):
    """``--probe``: phase 4, phase 7's kernels, phase 12's times of the
    main path's kernels on both layouts (K1's device time and estimated issue floor
    too), K8 on dense-512's compare input (bit-identical, chunk classes,
    device time by launch, bandwidth) and K7 on the orbit fused by K8,
    both then timed as in phase 12, and every kernel's resident blocks an
    SM."""
    errs, calls, bounds, _, st_box = box_kernels(intr, poses, frames, device, card)
    f32, st = f32_kernels(intr, poses, frames, device, card)
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
    vol = tsdf_new(RES, 3.0, 0.03, dtype=torch.float32, device=device)
    for d, p in zip(frames, pose_t):
        vol, _ = tsdf_integrate_with_planes(vol, d, p, intr)
    _, dense["planes_extract"], k7_bound = compare_extract(vol, f"dense-{RES}", card)
    render_ms(vol, pose_t[N_FRAMES], intr, card)
    time_kernels(list(dense), dense, {"tsdf_dense": k8_bound, "planes_extract": k7_bound}, card)
    del dense, vol
    torch.cuda.empty_cache()
    occupancy_report(intr, card)
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
    no host synchronisation; then, on its last frame, K1, K3, K4, K5 and
    K6 against their plain versions with phase 4's bounds
    (``compare_kernels``)."""
    from housescan_tpu_torch.kinfu.pipeline import kinfu_init, kinfu_step
    from housescan_tpu_torch.ops import cuda_lib

    pose1 = torch.from_numpy(poses[1]).to(device)
    for tag, noise, factor in WORLDS:
        frames = world_frames(intr, poses, device, noise)
        budget = ((0.15 + 150.0 * noise) * N_FRAMES + 2.0) * factor
        cuda_lib.reset_counts()
        st, tracked = run_orbit(intr, poses, frames, RES, device)
        launches, plain = dict(cuda_lib.launch_counts), dict(cuda_lib.plain_counts)
        err_mm = float(np.linalg.norm(st.pose[3, :3].cpu().numpy() - poses[N_FRAMES][3, :3])) * 1e3
        print(f"# {tag} {intr.width}x{intr.height} (packed volume): {N_FRAMES} frames; "
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


def room_cycle(dirs, device, out):
    """The room stage over the scanned room directories with every scene on
    ``device``: load, corners (suggestions accepted as
    tests/test_end_to_end.py accepts them), cuboid fit, room 1 moved 3 m
    along x, the facing walls connected, positions optimised, .xf files,
    placed full-resolution clouds; that test's assertions. Returns (the
    rooms, their cuboid rmse, the optimiser's results, the .xf matrices,
    placed point counts)."""
    from itertools import product

    from housescan_tpu_torch.io.pcd import load_pcd
    from housescan_tpu_torch.io.xf import load_xf
    from housescan_tpu_torch.rooms import (
        Scene, WallRelation, connect_walls, export_all_room_xf_files, export_room_full_res,
        fit_cuboid_to_room, load_room, optimize_room_positions, suggest_corners, translate_room,
    )
    from housescan_tpu_torch.rooms.corners import accept_corner_suggestion

    scene = Scene(device=device)
    rooms = []
    for d in dirs:
        room = load_room(scene, d)
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
    rmses = []
    for i, room in enumerate(rooms):
        fit = fit_cuboid_to_room(scene, room)
        if fit is None or not fit[1] < 0.02:
            fail(f"rooms on {device}: room {i} cuboid fit {None if fit is None else fit[1]}")
        rooms[i] = fit[0]
        rmses.append(fit[1])
    scene.update_room(translate_room(scene.rooms[rooms[1].room_id],
                                     np.array([3.0, 0.0, 0.0], np.float32), device=device))
    p0 = min(scene.rooms[rooms[0].room_id].planes, key=lambda p: p.normal[0])
    p1 = max(scene.rooms[rooms[1].room_id].planes, key=lambda p: p.normal[0])
    if connect_walls(scene, p0.plane_id, p1.plane_id, WallRelation.opposite(0.1)) is None:
        fail(f"rooms on {device}: the facing walls did not connect")
    results = optimize_room_positions(scene)
    if not results or not all(np.isfinite(r[2]) for r in results):
        fail(f"rooms on {device}: optimize_room_positions gave {results}")
    xfs = export_all_room_xf_files(scene, os.path.join(out, f"xf_{device}"))
    if len(xfs) != 2:
        fail(f"rooms on {device}: {len(xfs)} .xf files")
    placed = []
    for room in rooms:
        path = export_room_full_res(scene.rooms[room.room_id],
                                    os.path.join(out, f"placed_{device}_{room.room_id}.pcd"),
                                    device=device)
        placed.append(len(load_pcd(path)))
    if min(placed) <= 1000:
        fail(f"rooms on {device}: placed clouds of {placed} points")
    return ([scene.rooms[r.room_id] for r in rooms], rmses, results, [load_xf(x) for x in xfs],
            placed)


def run_rooms(intr, device):
    """Phase 15: two rooms scanned with ``scan_to_room_dir`` at ``Config()``
    (512^3 float32, 640x480; 32 known poses each, tests/test_end_to_end.py's
    sweeps), then the room stage on the card (``room_cycle``), then again
    on the CPU from the same directories; the card held to the CPU:
    corners within 1e-4 m (as point sets: a cuboid's parametrisation is
    not unique), cuboid rmse within 1e-5, optimised corner means within
    1e-4 m, .xf matrices within 1e-5."""
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
        dirs.append(scan_to_room_dir(DepthStream(frames=frames, intrinsics=intr),
                                     os.path.join(out, f"scan{ri}"), config=Config(),
                                     init_pose=poses[0], known_poses=poses))
        del frames
    launches, plain = dict(cuda_lib.launch_counts), dict(cuda_lib.plain_counts)
    print(f"# rooms: scans' launches {json.dumps(launches)} plain {json.dumps(plain)}", flush=True)
    # known poses skip tracking, so neither K1 (the tracker's filter), K11 nor K3 runs
    check_counts("the room scans", launches, plain,
                 tuple(k for k in cuda_lib.KERNEL_PATH
                       if k not in ("bilateral", "pyramid", "icp_level")))
    torch.cuda.empty_cache()

    (gr, grm, gres, gxf, gpl), (cr, crm, cres, cxf, cpl) = (room_cycle(dirs, d, out)
                                                            for d in ("cuda", "cpu"))
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


def bf16_parity(intr, poses, frames, device, card):
    """The full-width twin of the reference's test_bf16_parity_with_f32:
    frame 0 fused into a fresh bfloat16 and a fresh float32 512^3 volume
    (K5 then K4): weights identical, the tsdf within 5e-4 where |t| < 0.1
    and within 4.5e-3 (a bfloat16 ulp at |t| <= 1) wherever observed."""
    from housescan_tpu_torch.kinfu.tsdf import tsdf_new
    from housescan_tpu_torch.ops.tsdf_stream import planes_shape, tsdf_integrate_stream

    pose0 = torch.from_numpy(poses[0]).to(device)
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        vol = tsdf_new(RES, 3.0, 0.03, dtype=dtype, device=device)
        tsdf_integrate_stream(vol, torch.zeros(planes_shape(RES), device=device), frames[0],
                              pose0, intr)
        out[dtype] = vol.data
    a, b = out[torch.float32], out[torch.bfloat16]
    if not torch.equal(a[1], b[1].float()):
        fail("box-512-bf16 parity: the weights differ from the float32 volume's")
    obs = a[1] > 0
    diff = (a[0] - b[0].float()).abs()
    near = obs & (a[0].abs() < 0.1)
    n_near, d_near, d_all = int(near.sum()), float(diff[near].max()), float(diff[obs].max())
    print(f"# box-{RES}-bf16 against float32, frame 0: weights identical, {int(obs.sum())} "
          f"observed voxels, |dt| max {d_near:.3e} on the {n_near} with |t| < 0.1 (bound 5e-4), "
          f"{d_all:.3e} everywhere observed (bound 4.5e-3) [{card}]", flush=True)
    if n_near < 500 or d_near >= 5e-4 or d_all >= 4.5e-3:
        fail("box-512-bf16 parity with float32 out of its bounds")


def run_bf16(intr, poses, frames, device, card, f32_times, times, bounds):
    """Phase 16, box-512-bf16: the kernel path on the bfloat16 volume. A
    warm pass, K4 and K5 against their plain versions (bit-identical), K4
    and K5 on the empty list, split against unsplit bit-identical, K7 as
    the oracle of K4's planes and against its plain version
    (bit-identical), the bfloat16 parity with float32 at full width; the
    warm orbit gated as phase 4's (``warm_states``); K4, K5 and K7 timed
    beside their float32 times of phase 12. Returns the rows of the
    kernels line."""
    pose1 = torch.from_numpy(poses[1]).to(device)
    st, st0, launches = warm_states(intr, poses, frames, device, torch.bfloat16, card)
    b16 = {"tsdf_stream@bf16": compare_stream(st, frames[N_FRAMES], intr),
           "tsdf_free@bf16": compare_free(st, st0, frames[N_FRAMES], frames[1], pose1, intr,
                                          card)}
    del st0
    stream_empty_list(st, frames[N_FRAMES], intr, card)
    from housescan_tpu_torch.ops import cuda_lib

    cuda_lib.reset_counts()
    diff7, n7, v7 = k7_oracle(st, frames[N_FRAMES], intr)
    k7_launches = cuda_lib.launch_counts["planes_extract"]  # K7's run: the oracle's extraction
    print(f"# box-{RES}-bf16 K7 as the oracle of K4's planes after a step: {n7} listed chunks, "
          f"{v7} valid sub-blocks, valid flags identical, fields max diff {diff7}", flush=True)
    err7, calls7, bound7 = compare_extract(st.volume, f"box-{RES} bf16", card)
    b16_times = time_f32(b16, card, layout="bfloat16")
    k7_ms, k7_plain = cuda_ms(calls7[0], REPS["planes_extract"][0]), \
        cuda_ms(calls7[1], REPS["planes_extract"][1])
    b16_times["planes_extract@bf16"] = (k7_ms, k7_plain) + tuple(bound7)
    errs = {name: r[0] for name, r in b16.items()}
    errs["planes_extract@bf16"] = err7
    del st, calls7, b16
    torch.cuda.empty_cache()
    same, observed = split_orbit_identical(intr, poses, frames, device, torch.bfloat16)
    if not same:
        fail("box-512-bf16: the orbit integrated with the free split differs from the unsplit one")
    print(f"# box-{RES}-bf16 split vs unsplit orbit (21 integrates at the true poses): "
          f"bit-identical, {observed} observed voxels", flush=True)
    bf16_parity(intr, poses, frames, device, card)
    torch.cuda.empty_cache()
    # beside the float32 times of this run (phase 12: K4 and K5 on
    # box-512-f32, K7 on dense-512's float32 volume and box-512's packed one)
    for name, (ms, plain_ms, bound_ms, bound_by) in b16_times.items():
        base = name.split("@")[0]
        f32 = f32_times.get(base) or (times[base][0], times[base][1], *bounds[base])
        print(f"# {name}: kernel {ms:.4f} ms (bound {bound_ms:.4f}, {bound_by}), plain "
              f"{plain_ms:.4f} ms; float32 kernel {f32[0]:.4f} ms (bound {f32[2]:.4f}) [{card}]",
              flush=True)
    rows = []
    for name, (ms, plain_ms, bound_ms, bound_by) in b16_times.items():
        base = name.split("@")[0]
        src, replaces = KERNELS[base]
        # launches: K4's and K5's in the bf16 orbit, K7's in its oracle run
        rows.append({"name": name, "route": "cuda", "source": src, "replaces": replaces,
                     "launches": launches[base] if base != "planes_extract" else k7_launches,
                     "max_abs_err": errs[name], "ms": ms, "plain_ms": plain_ms,
                     "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None})
    return rows


def sharded_maps_equal(sh, ref):
    """Teacher-forced parity of the sharded step with the single-device
    one (the reference's bound): pose, volume, planes, model vertices and
    valid mask bit-identical; normals within 5e-3 and over 1e-4 on fewer
    than 1% of pixels. Returns (normals' max diff, pixels over 1e-4)."""
    from housescan_tpu_torch.kinfu import maps as mp

    for what, a, b in (("pose", sh.pose, ref.pose), ("volume", sh.volume.data, ref.volume.data),
                       ("planes", sh.planes, ref.planes),
                       ("model vertices", sh.model_maps[mp.MD_V], ref.model_maps[mp.MD_V]),
                       ("valid mask", sh.model_maps[mp.MD_VALID], ref.model_maps[mp.MD_VALID])):
        if not torch.equal(a, b):
            fail(f"sharded-512: the {what} differs from the single-device step's")
    dn = (sh.model_maps[mp.MD_N] - ref.model_maps[mp.MD_N]).abs()
    n_flip = int((dn.amax(0) > 1e-4).sum())
    if float(dn.max()) >= 5e-3 or n_flip >= dn[0].numel() // 100:
        fail(f"sharded-512: normals differ by {float(dn.max())} on {n_flip} pixels over 1e-4")
    return float(dn.max()), n_flip


def compare_slab(pre, ref, depth, intr, i):
    """K5, K4 and K6 on X-slab ``i`` of ``pre`` (the sharded state cut from
    the single-device state before a frame) at the pose the single-device
    step ``ref`` fused the frame at, each with the slab's offset (params
    slots 24 and 26, ``block_x0``), against their plain versions on the
    same inputs: the free carve, then the integrate over the main list,
    then the ray cast of the slab's candidates. Each bit-identical, and
    the slab's volume and planes equal to the same X-range of ``ref``'s.
    Returns {kernel: max abs error}."""
    from housescan_tpu_torch.ops.chunk_select import build_worklist
    from housescan_tpu_torch.ops.raycast_tiles import (
        _ray_params, build_tile_candidates, launch_raycast_kernel, raycast_tiles_plain,
    )
    from housescan_tpu_torch.ops.tsdf_stream import (
        FIELD_SAT, N_QUARTERS, _stream_params, build_depth_mips, free_carve_plain,
        integrate_plain, launch_free_kernel, launch_stream_kernel,
    )

    vol, planes, pose = pre.volume.slab(i), pre.planes[i], ref.pose
    nbx, nzc = RES // 8, RES // 128
    nbl = planes.shape[0]
    bx0 = nbl * i
    tag = f"slab {i} of {len(pre.volume.slabs)}, block_x0 {bx0}"
    sat = planes[:, :, :, FIELD_SAT, :N_QUARTERS].reshape(-1, N_QUARTERS) > 0.5
    neg = planes[:, :, :, FIELD_SAT, N_QUARTERS].reshape(-1) > 0.5
    wl, fwl = build_worklist(depth, pose, intr, vol.dims, vol.voxel_size, vol.origin, vol.trunc,
                             sat_quarters=sat, block_x0=bx0, neg_flags=neg, free_split=True)
    params = _stream_params(vol, pose, intr, 128.0, nbx, nzc, bx0)
    mips = build_depth_mips(depth)
    errs = {}
    kd, kp = vol.data.clone(), planes.clone()
    qd, qp = vol.data.clone(), planes.clone()
    for name, kernel, plain in (
        ("tsdf_free", lambda: launch_free_kernel(kd, kp, fwl, params),
         lambda: free_carve_plain(qd, qp, fwl, params, bx0)),
        ("tsdf_stream", lambda: launch_stream_kernel(kd, kp, wl.desc, wl.count, mips, params),
         lambda: integrate_plain(qd, qp, wl.desc, wl.count, mips, params, nbx, nzc, bx0)),
    ):
        kernel()
        plain()
        torch.cuda.synchronize()
        (kt, kw), (qt, qw) = _tw(kd), _tw(qd)
        errs[name] = max(float((kt - qt).abs().max()), float((kw - qw).abs().max()),
                         float((kp - qp).abs().max()))
        if not (torch.equal(kd, qd) and torch.equal(kp, qp)):
            fail(f"sharded-{RES} {tag}: {name} differs from its plain version ({errs[name]})")
    xs = slice(bx0 * 8, (bx0 + nbl) * 8)
    if not (torch.equal(kd, ref.volume.data[xs]) and torch.equal(kp, ref.planes[bx0:bx0 + nbl])):
        fail(f"sharded-{RES} {tag}: the slab differs from the single-device step's X-range")
    n_ut = -(-intr.width // 128)
    w_pad = n_ut * 128
    cand = build_tile_candidates(kp, pose, intr, vol, block_x0=bx0)
    rparams = _ray_params(pose, intr, 0.3, n_ut)
    k6 = launch_raycast_kernel(cand, rparams, intr.height, w_pad)
    q6 = raycast_tiles_plain(cand, rparams, intr.height, w_pad)
    torch.cuda.synchronize()
    errs["raycast_tiles"] = float((k6 - q6).abs().nan_to_num(float("inf")).max())
    if not torch.equal(k6, q6):
        fail(f"sharded-{RES} {tag}: K6 differs from its plain version ({errs['raycast_tiles']})")
    n_hit = int((q6[0] > 0).sum())
    print(f"# sharded-{RES} {tag}: K5 over {int(fwl.count[0])} free entries, K4 over "
          f"{int(wl.count[0])} listed chunks, K6 over {int((cand[:, :, 9] > 0.5).sum())} "
          f"candidates ({n_hit} pixels hit): each bit-identical to its plain version, the slab "
          f"equal to the single-device step's X-range", flush=True)
    return errs, int(fwl.count[0]), int(wl.count[0]), n_hit


def run_sharded(intr, poses, frames, device, card, box_pose):
    """Phase 17, sharded-512: the X-slab sharded kernel-path step on a
    4-slab mesh of this one card (4 x 128 x 512 x 512 packed slabs).
    Frames 0-2 teacher-forced from the single-device state
    (``sharded_maps_equal``); then the orbit runs free from a fresh state:
    pose error <= 5 mm and within 2 mm of box-512's final position, K1
    and K3 launched, K4, K5 and K6 four times a step, no plain version, no
    host synchronisation in one more step. On frame 2, K5, K4
    and K6 on each slab but the first against their plain versions at the
    slab's shapes and offset (``compare_slab``). Then the XLA path
    on 4 slabs at 480^3: frame 0's integrate against the single-device
    one (bit-identical: within the reference's 1e-5), and 3 frames each tracked (the pose
    within half a frame's motion, 2.5 mm, of the truth). Returns the free
    run's launches and the slab comparisons' largest errors."""
    from housescan_tpu_torch.kinfu.pipeline import kinfu_init, kinfu_step
    from housescan_tpu_torch.kinfu.tsdf import tsdf_integrate, tsdf_new
    from housescan_tpu_torch.ops import cuda_lib
    from housescan_tpu_torch.parallel import make_mesh, make_sharded_step, sharded_kinfu_init
    from housescan_tpu_torch.parallel.sharded import (
        sharded_state_from_single,
        single_state_from_sharded,
    )

    mesh = make_mesh(4, devices=[device] * 4)
    step = make_sharded_step(mesh, intr, iterations=(10, 5, 4), use_pallas=True)
    ref = kinfu_init(intr, resolution=RES, size_m=3.0, trunc=0.03, init_pose=poses[0],
                     dtype=torch.int32, device=device)
    slab_errs = {}
    for k in range(3):
        pre = sharded_state_from_single(mesh, ref, True)
        sh = single_state_from_sharded(step(sharded_state_from_single(mesh, ref, True), frames[k]))
        ref = kinfu_step(ref, frames[k], intr)
        torch.cuda.synchronize()
        dn, n_flip = sharded_maps_equal(sh, ref)
        print(f"# sharded-{RES} frame {k} teacher-forced (4 slabs on one card): pose, volume, "
              f"planes, vertices, valid mask bit-identical; normals max diff {dn:.3e}, "
              f"{n_flip} px over 1e-4", flush=True)
        del sh
        if k == 2:
            # each slab but the first against the plain versions, at this
            # frame's shapes: (128, 512, 512) packed slabs, 640x480
            sizes = []
            for i in range(1, mesh.size):
                errs, *n = compare_slab(pre, ref, frames[k], intr, i)
                sizes.append(n)
                for name, e in errs.items():
                    slab_errs[name] = max(slab_errs.get(name, 0.0), e)
            if not any(n[0] for n in sizes) or not all(n[1] and n[2] for n in sizes):
                fail(f"sharded-{RES}: a slab comparison had an empty list or no hit ({sizes})")
        del pre
    del ref
    torch.cuda.empty_cache()

    st = sharded_kinfu_init(mesh, intr, resolution=RES, size_m=3.0, trunc=0.03,
                            init_pose=poses[0], use_pallas=True)
    if st.volume.slabs[0].shape != (RES // 4, RES, RES) or st.volume.slabs[0].dtype != torch.int32:
        fail(f"sharded-{RES}: the slabs are {tuple(st.volume.slabs[0].shape)}")
    cuda_lib.reset_counts()
    for i in range(N_FRAMES + 1):
        st = step(st, frames[i])
    launches, plain = dict(cuda_lib.launch_counts), dict(cuda_lib.plain_counts)
    pos = st.pose[3, :3].cpu().numpy()
    err_mm = float(np.linalg.norm(pos - poses[N_FRAMES][3, :3])) * 1e3
    d_box = float(np.linalg.norm(pos - box_pose)) * 1e3
    print(f"# sharded-{RES} {intr.width}x{intr.height} (4 packed slabs of "
          f"{tuple(st.volume.slabs[0].shape)} on one card): {N_FRAMES} frames; pose error "
          f"{err_mm:.3f} mm, {d_box:.3f} mm from box-{RES}'s final position [{card}]", flush=True)
    print(f"# sharded-{RES} launches {json.dumps(launches)} plain {json.dumps(plain)}", flush=True)
    n_steps = N_FRAMES + 1
    want = {"bilateral": n_steps, "pyramid": n_steps, "icp_level": 3 * n_steps,
            "tsdf_stream": 4 * n_steps, "tsdf_free": 4 * n_steps, "raycast_tiles": 4 * n_steps,
            "chunk_select": 4 * n_steps}
    check_counts(f"sharded-{RES}", launches, plain, cuda_lib.KERNEL_PATH)
    if any(launches[k] != n for k, n in want.items()):
        fail(f"sharded-{RES}: launches {launches}, expected {want}")
    if err_mm > POSE_BUDGET_MM or d_box > 2.0:
        fail(f"sharded-{RES}: pose error {err_mm:.3f} mm, {d_box:.3f} mm from box-{RES}'s")
    _, syncs = host_syncs(lambda: step(st, frames[N_FRAMES]))
    print(f"# sharded-{RES}: one more step made {len(syncs)} host synchronisations {syncs}",
          flush=True)
    if syncs:
        fail(f"the sharded-{RES} step made the host wait on the card at {syncs}")
    del st
    torch.cuda.empty_cache()

    # the XLA path on 4 slabs at 480^3
    xstep = make_sharded_step(mesh, intr, iterations=(10, 5, 4), use_pallas=False)
    xs = sharded_kinfu_init(mesh, intr, resolution=XLA_RES, size_m=3.0, trunc=0.03,
                            init_pose=poses[0])
    xs = xstep(xs, frames[0])
    single = tsdf_integrate(tsdf_new(XLA_RES, 3.0, 0.03, device=device), frames[0],
                            torch.from_numpy(poses[0]).to(device), intr)
    got = xs.volume.gather()
    dt = float((got.data[0] - single.data[0]).abs().max())
    # the reference's bound is 1e-5 (its slab-local origins); the
    # port's slabs take the whole volume's voxel centres: bit-identical
    if not torch.equal(got.data, single.data):
        fail(f"sharded-xla-{XLA_RES}: frame 0's integrate differs from the single-device one "
             f"(tsdf {dt})")
    del got, single
    errs = []
    for k in (1, 2):
        xs = xstep(xs, frames[k])
        errs.append(float(np.linalg.norm(xs.pose[3, :3].cpu().numpy() - poses[k][3, :3])) * 1e3)
    print(f"# sharded-xla-{XLA_RES} (4 float32 slabs on one card): frame 0 integrate against "
          f"the single-device one: bit-identical (tsdf max diff {dt:.3e}); frames 1-2 pose "
          f"error {[round(e, 4) for e in errs]} mm [{card}]", flush=True)
    if max(errs) > 2.5:
        fail(f"sharded-xla-{XLA_RES}: a frame was not tracked (pose errors {errs} mm)")
    del xs
    torch.cuda.empty_cache()
    return launches, slab_errs


def run_building(intr, device, card):
    """Phase 18, building: ``scan_building`` at ``Config()`` over two
    rooms (512^3, 640x480, phase 15's 32 known poses each), once with no
    mesh (each room through ``scan_to_room_dir``, float32) and once on the
    4-slab mesh of this card (the sharded route, packed, and
    ``fit_cuboids_sharded``); tests/test_building.py's end-to-end
    assertions on both, the same rooms finished with the same wall
    connections, and the placed rooms' corner means within 2 mm: the two
    volumes differ by the packed layout's rounding (a step of 0.9 um of
    signed distance), which can move a zero crossing's voxel and so the
    sampled cloud RANSAC fits, but not a wall's fitted offset by more than
    a third of a 5.9 mm voxel."""
    from housescan_tpu_torch.capture.replay import DepthStream
    from housescan_tpu_torch.config import Config
    from housescan_tpu_torch.kinfu.building import RoomScan, scan_building
    from housescan_tpu_torch.kinfu.synthetic import furnished_room, render_depth_stream
    from housescan_tpu_torch.ops import cuda_lib
    from housescan_tpu_torch.parallel import make_mesh

    half, boxes = furnished_room()
    rooms = []
    for ri in range(2):
        poses = room_poses(ri)
        frames = render_depth_stream(intr, poses, half, boxes, seed=ri, device=device).cpu().numpy()
        rooms.append(RoomScan(name=f"room{ri}", stream=DepthStream(frames=frames, intrinsics=intr),
                              init_pose=poses[0], known_poses=poses))
    out = {}
    for route, mesh in (("single", None), ("sharded", make_mesh(4, devices=[device] * 4))):
        d = os.path.join(OUT, f"building_{route}")
        shutil.rmtree(d, ignore_errors=True)
        cuda_lib.reset_counts()
        scene, fitted, bdir = scan_building(rooms, d, config=Config(), mesh=mesh)
        launches = dict(cuda_lib.launch_counts)
        bc = json.loads((bdir / "building_checkpoint.json").read_text())
        print(f"# building ({route}): fit rmse {bc['fit_rmse']}, {bc['n_wall_connections']} wall "
              f"connections, optimiser {bc['optimize']}; launches {json.dumps(launches)} [{card}]",
              flush=True)
        if len(scene.rooms) != 2 or len(fitted) != 2 or bc["rooms_done"] != ["room0", "room1"]:
            fail(f"building ({route}): {len(scene.rooms)} rooms, done {bc['rooms_done']}")
        for r in rooms:
            for f in ("cloud_downsampled.pcd", "planes.txt", "trajectory.npz"):
                if not (bdir / r.name / f).exists():
                    fail(f"building ({route}): {r.name}/{f} missing")
        if len(sorted((bdir / "xf").glob("*.xf"))) != 2 or any(len(r.planes) < 2 for r in fitted):
            fail(f"building ({route}): .xf files or fitted planes missing")
        want = ("tsdf_stream", "tsdf_free", "raycast_tiles")
        if any(launches[k] == 0 for k in want) or any(cuda_lib.plain_counts.values()):
            fail(f"building ({route}): the fusion kernels did not run on the card")
        out[route] = (bc, [r.corner_mean() for r in fitted])
    (bs, ms), (bh, mh) = out["single"], out["sharded"]
    d_pos = max(float(np.abs(a - b).max()) for a, b in zip(ms, mh)) * 1e3
    print(f"# building: the sharded route against the single-device one: placed corner means "
          f"within {d_pos:.4f} mm (bound 2 mm), wall connections {bs['n_wall_connections']} / "
          f"{bh['n_wall_connections']} [{card}]", flush=True)
    if bs["rooms_done"] != bh["rooms_done"] or bs["n_wall_connections"] != bh["n_wall_connections"] \
            or bs["n_wall_connections"] < 1 or d_pos > 2.0:
        fail("building: the sharded route's building differs from the single-device one's")


# The device kernels' symbols of the kernel path, which phase 19's device
# trace must name.
TRACE_KERNELS = {"bilateral": "bilateral_kernel", "pyramid": "pyramid_level_kernel",
                 "icp_level": "icp_level_kernel",
                 "tsdf_stream": "tsdf_stream_kernel", "tsdf_free": "tsdf_free_kernel",
                 "raycast_tiles": "raycast_tiles_kernel", "chunk_select": "chunk_classify_kernel"}


def cli(args, what, card, device="cuda"):
    """``housescan_tpu_torch.cli.main(["--device", device, *args])`` in this
    process; returns its standard output and prints its last lines. A
    command that exits (the CLI's SystemExit on a refused input) fails the
    phase."""
    import contextlib
    import io

    from housescan_tpu_torch.cli import main as cli_main

    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            cli_main(["--device", device, *args])
    except SystemExit as e:
        fail(f"cli {what}: exited ({e}); output: {buf.getvalue()[-2000:]}")
    out = buf.getvalue()
    print(f"# cli {what} [{card}]: " + " | ".join(out.strip().splitlines()[-3:]), flush=True)
    return out


def relative_error_mm(traj, truth, first):
    """Translation error of the last trajectory row against the true
    motion from the first fused frame (``first``, a true pose) to
    ``truth``: a scan with no initial pose starts at the identity."""
    want = truth.astype(np.float64) @ np.linalg.inv(first.astype(np.float64))
    return float(np.linalg.norm(traj[-1, 3, :3] - want[3, :3])) * 1000.0


def library_trajectory(frames, intr, cfg, out, device):
    """``scan_to_room_dir`` called directly on ``frames`` (host float32
    meters) with the command line's arguments: no initial pose, so the
    identity. Returns its trajectory."""
    from housescan_tpu_torch.capture.replay import DepthStream
    from housescan_tpu_torch.kinfu.scan import scan_to_room_dir

    d = scan_to_room_dir(DepthStream(frames=np.asarray(frames), intrinsics=intr), out,
                         config=cfg, device=device)
    return np.load(os.path.join(d, "trajectory.npz"))["poses"]


def cli_live(stream_path, frames_mm, poses, out, card, flags, device, realtime, intr, cfg,
             uncounted):
    """``scan --live`` over ``HOUSESCAN_FAKE_DEVICE`` = the recording; the
    frames the scan read are matched to the recording by their pixels.
    Fails unless the live source opened, every frame read was fused, and
    the trajectory equals ``scan_to_room_dir``'s on the frames read."""
    from housescan_tpu_torch.capture import live

    reads = []
    orig_read = live.LiveSource.read

    def recording_read(self):
        frame = orig_read(self)
        if frame is not None:
            reads.append(frame)
        return frame

    opened = []
    orig_open = live.open_live_source

    def recording_open(*a, **k):
        src = orig_open(*a, **k)
        opened.append(src)
        return src

    live.LiveSource.read = recording_read
    live.open_live_source = recording_open
    os.environ["HOUSESCAN_FAKE_DEVICE"] = stream_path
    tag = "scan --live --realtime" if realtime else "scan --live"
    try:
        text = cli(["scan", "--live", "--max-frames", str(len(frames_mm)), *flags,
                    *(["--realtime"] if realtime else []), out], tag, card, device)
    finally:
        live.LiveSource.read = orig_read
        live.open_live_source = orig_open
        del os.environ["HOUSESCAN_FAKE_DEVICE"]
    if not opened or opened[0] is None:
        fail(f"cli {tag}: open_live_source returned None")
    src = opened[0]
    idx = []
    for f in reads:
        mm = np.round(f / 0.001).astype(np.uint16)
        hits = [i for i in range(len(frames_mm)) if np.array_equal(mm, frames_mm[i])]
        if not hits:
            fail(f"cli {tag}: a frame read matches no recorded frame")
        idx.append(hits[0])
    traj = np.load(os.path.join(out, "trajectory.npz"))["poses"]
    err = relative_error_mm(traj, poses[idx[-1]], poses[idx[0]])
    lib = uncounted(library_trajectory, reads, intr, cfg, out + "_library", device)
    d_lib = float(np.abs(lib - traj).max()) if lib.shape == traj.shape else float("inf")
    print(f"# cli {tag}: read {src.frames_read} frames {idx} (dropped {src.dropped}), fused "
          f"{len(traj)}, the trajectory within {d_lib:.3e} of scan_to_room_dir's on the frames "
          f"read; pose error {err:.3f} mm from frame {idx[0]} (identity start) [{card}]",
          flush=True)
    if not (src.frames_read == len(reads) == len(traj) >= 1) or \
            f"fused {src.frames_read} frames" not in text:
        fail(f"cli {tag}: {src.frames_read} frames read, {len(traj)} fused")
    if d_lib > 1e-6:
        fail(f"cli {tag}: the trajectory differs from scan_to_room_dir's by {d_lib}")
    return dict(read=src.frames_read, dropped=src.dropped, err_mm=err, library_diff=d_lib)


def run_cli(intr, poses, frames, card, device="cuda", flags=(), cfg=None, rooms_dir=None):
    """Phase 19: the command line on the card, in this process (see the
    module docstring). ``flags`` are the volume flags of every scanning
    command and ``cfg`` the ``Config`` they make (none: ``Config()``,
    512^3); ``rooms_dir`` holds phase 15's scanned rooms. Returns the
    phase's launches.

    The command line starts a scan at the identity pose. From there the
    bench orbit's motion is not tracked, in the JAX package's scan as in
    the port's (the orbit turns about a point 0.25 m behind the camera;
    from the identity its x motion is lost: 95 mm over the 20 frames), so
    a command's scan is held to ``scan_to_room_dir`` called directly with
    the command's arguments (the same trajectory within 1e-6), and phase
    8 holds that function to the 5 mm budget from the first frame's pose.
    The identity start's pose error is printed."""
    import importlib

    from housescan_tpu_torch.capture.replay import record_stream
    from housescan_tpu_torch.io.checkpoint import load_scene, save_scene
    from housescan_tpu_torch.io.xf import load_xf
    from housescan_tpu_torch.kinfu.synthetic import furnished_room, render_depth_stream
    from housescan_tpu_torch.ops import cuda_lib
    from housescan_tpu_torch.rooms import load_room
    from housescan_tpu_torch.rooms.types import Scene

    from housescan_tpu_torch.config import Config

    cfg = cfg or Config()
    on_card = device.startswith("cuda")
    out = os.path.join(OUT, "cli")
    shutil.rmtree(out, ignore_errors=True)
    os.makedirs(out)
    flags = list(flags)
    launches, plain_runs = dict.fromkeys(KERNELS, 0), dict.fromkeys(KERNELS, 0)

    def uncounted(fn, *args):
        """``fn(*args)`` with the counters left as they were: a comparison,
        not the command line."""
        lib = sys.modules["housescan_tpu_torch.ops.cuda_lib"]
        saved = dict(lib.launch_counts), dict(lib.plain_counts)
        out = fn(*args)
        lib.launch_counts.update(saved[0])
        lib.plain_counts.update(saved[1])
        return out

    def take_counts():
        """Add the counters to the phase's and set them to 0; returns the
        plain versions run since the last call."""
        lib = sys.modules["housescan_tpu_torch.ops.cuda_lib"]  # a reload rebinds its counters
        plain = dict(lib.plain_counts)
        for k in KERNELS:
            launches[k] += lib.launch_counts[k]
            plain_runs[k] += plain[k]
        lib.reset_counts()
        return plain

    # 1. the bench orbit, recorded as uint16 mm with its poses
    orbit = str(record_stream(os.path.join(out, "orbit.npz"), frames, intr, poses=poses))
    frames_mm = np.load(orbit)["depth_mm"]
    scene_path = os.path.join(out, "scene.housescan")
    room_a = os.path.join(out, "room_a")

    # 2. scan with a mesh and a checkpoint every 10 frames, then resume
    cuda_lib.reset_counts()  # what earlier phases launched is not this phase's
    take_counts()
    cli(["--scene", scene_path, "scan", orbit, room_a, "--mesh", "--checkpoint-every", "10",
         *flags], "scan", card, device)
    scan_launches = dict(launches)
    plain = take_counts()
    scan_launches = {k: launches[k] - scan_launches[k] for k in KERNELS}
    if on_card:
        check_counts("cli scan", scan_launches, plain, cuda_lib.KERNEL_PATH + ("marching_tets",))
    traj = np.load(os.path.join(room_a, "trajectory.npz"))["poses"]
    err = relative_error_mm(traj, poses[-1], poses[0])
    lib = uncounted(library_trajectory, frames_mm.astype(np.float32) * np.float32(0.001),
                    intr, cfg, os.path.join(out, "room_a_library"), device)
    d_lib = float(np.abs(lib - traj).max()) if lib.shape == traj.shape else float("inf")
    if traj.shape[0] != len(poses) or d_lib > 1e-6:
        fail(f"cli scan: {traj.shape[0]} poses, {d_lib} from scan_to_room_dir's trajectory")
    room = load_room(Scene(device=device), room_a)
    if len(room.planes) < 2 or len(room.cloud.points) < 1000:
        fail(f"cli scan: room_a has {len(room.planes)} planes, {len(room.cloud.points)} points")
    ck_bytes = os.path.getsize(os.path.join(room_a, "scan_checkpoint.npz"))
    cli(["--scene", scene_path, "scan", orbit, room_a, "--resume", "--checkpoint-every", "10",
         *flags], "scan --resume", card, device)
    traj2 = np.load(os.path.join(room_a, "trajectory.npz"))["poses"]
    resume_err = float(np.abs(traj2 - traj).max())
    print(f"# cli scan: the trajectory within {d_lib:.3e} of scan_to_room_dir's; pose "
          f"error {err:.3f} mm (from the identity start), {len(room.planes)} planes; scan "
          f"checkpoint {ck_bytes} bytes; the resumed trajectory within {resume_err:.3e} of the "
          f"first [{card}]", flush=True)
    if traj2.shape != traj.shape or resume_err > 1e-6:
        fail(f"cli scan --resume: the trajectory moved by {resume_err}")

    # 3. the live scan over the recording, unpaced and paced at 30 fps
    live_stats = [cli_live(orbit, frames_mm, poses, os.path.join(out, f"room_live{k}"), card,
                           flags, device, bool(k), intr, cfg, uncounted)
                  for k in (0, 1)]
    take_counts()

    # 4. the room stage on room_a and phase 15's two scanned rooms
    dirs = [os.path.join(rooms_dir, f"scan{ri}") for ri in range(2)]
    for d in (room_a, *dirs):
        cli(["--scene", scene_path, "add-room", d], "add-room", card, device)
    sc = load_scene(scene_path, device="cpu")
    ids = sorted(sc.rooms)
    for rid in ids:
        cli(["--scene", scene_path, "suggest", "--room", str(rid), "--cutoff", "1.3"],
            "suggest", card, device)
    # as room_cycle: where suggest left fewer than 8 corners, accept the
    # suggestions nearest the cloud's bounding-box corners
    from itertools import product

    sc = load_scene(scene_path, device="cpu")
    for rid in ids[1:]:
        r = sc.rooms[rid]
        if len(r.corners) == 8:
            continue
        lo, hi = r.cloud.points.min(0), r.cloud.points.max(0)
        for sx, sy, sz in product((0, 1), repeat=3):
            target = np.array([[lo[0], hi[0]][sx], [lo[1], hi[1]][sy], [lo[2], hi[2]][sz]])
            sid, spt = min(r.suggested_corners, key=lambda s: np.linalg.norm(s[1] - target))
            r.suggested_corners = [s for s in r.suggested_corners if s[0] != sid]
            cli(["--scene", scene_path, "accept-corner", "--room", str(rid), str(sid)],
                "accept-corner", card, device)
    for rid in ids[1:]:
        cli(["--scene", scene_path, "fit-cuboid", "--room", str(rid)], "fit-cuboid",
            card, device)
        cli(["--scene", scene_path, "auto-align", "--room", str(rid)], "auto-align",
            card, device)
    cli(["--scene", scene_path, "move", "--room", str(ids[2]), "3", "0", "0"], "move",
        card, device)
    sc = load_scene(scene_path, device="cpu")
    p0 = min(sc.rooms[ids[1]].planes, key=lambda p: p.normal[0])
    p1 = max(sc.rooms[ids[2]].planes, key=lambda p: p.normal[0])
    cli(["--scene", scene_path, "connect", str(p0.plane_id), str(p1.plane_id)], "connect",
        card, device)
    text = cli(["--scene", scene_path, "optimize"], "optimize", card, device)
    if "aligned" not in text:
        fail("cli optimize: no wall connection was optimised")
    export = os.path.join(out, "export")
    cli(["--scene", scene_path, "export", "--out", export, "--full-res"], "export",
        card, device)
    image = os.path.join(out, "scene.ppm")
    cli(["--scene", scene_path, "render", "--out", image, "--width", "640", "--height", "480"],
        "render", card, device)
    info = cli(["--scene", scene_path, "info"], "info", card, device)
    sc = load_scene(scene_path, device="cpu")
    again = os.path.join(out, "scene_again.housescan")
    save_scene(sc, again)
    sc2 = load_scene(again, device="cpu")
    same = sc2.next_id == sc.next_id and sorted(sc2.rooms) == sorted(sc.rooms) and all(
        np.array_equal(sc.rooms[r].cloud.points, sc2.rooms[r].cloud.points)
        and np.array_equal(sc.rooms[r].proj, sc2.rooms[r].proj)
        and [p.plane_id for p in sc.rooms[r].planes] == [p.plane_id for p in sc2.rooms[r].planes]
        for r in sc.rooms)
    xfs = sorted(os.listdir(os.path.join(export, "xf")))
    xf_ok = len(xfs) == 3 and all(np.isfinite(load_xf(os.path.join(export, "xf", x))).all()
                                  for x in xfs)
    with open(image, "rb") as f:
        data = f.read()
    head = b"P6\n640 480\n255\n"
    img = np.frombuffer(data[len(head):], np.uint8).reshape(480, 640, 3)
    nonbg = float((np.abs(img.astype(int) - 20) > 4).any(axis=-1).mean())
    placed = sorted(x for x in os.listdir(export) if x.endswith("-placed.ply"))
    fitted = [len(sc.rooms[r].corners) for r in ids]
    print(f"# cli room stage: {len(sc.rooms)} rooms, corners {fitted}, "
          f"{len(sc.connected_walls)} wall connection(s), {len(xfs)} .xf files, placed {placed}, "
          f"image non-background {nonbg:.3f}; scene round-trips {same}; scene checkpoint "
          f"{os.path.getsize(scene_path)} bytes [{card}]", flush=True)
    if not (same and xf_ok and data.startswith(head) and nonbg > 0.05 and len(placed) == 3
            and len(sc.connected_walls) == 1 and info.startswith("scene: 3 rooms")):
        fail("cli room stage: the scene, the .xf files, the export or the image is wrong")

    # 5. planes of the scanned cloud
    text = cli(["detect-planes", os.path.join(room_a, "cloud_downsampled.pcd")], "detect-planes",
               card, device)
    if int(text.split("detected ")[1].split()[0]) < 2:
        fail(f"cli detect-planes: {text.strip()}")

    # 6. and 7. phase 18's two rooms: scan-building on the visible cards,
    # then the 2 x 2 rooms x slabs re-fuse with every slab on one device
    half, boxes = furnished_room()
    streams, trajs = [], []
    for ri in range(2):
        rp = room_poses(ri)
        rf = render_depth_stream(intr, rp, half, boxes, seed=ri, device=device)
        streams.append(str(record_stream(os.path.join(out, f"room{ri}.npz"), rf, intr, poses=rp)))
        trajs.append(os.path.join(out, f"room{ri}_poses.npz"))
        np.savez(trajs[-1], poses=rp)
        del rf
    take_counts()
    building = os.path.join(out, "building")
    text = cli(["--scene", os.path.join(out, "building.housescan"), "scan-building", "--sharded",
                "--known-poses", building, *streams, *flags], "scan-building --sharded",
               card, device)
    bc = json.loads(open(os.path.join(building, "building_checkpoint.json")).read())
    if bc["rooms_done"] != ["room0", "room1"] or bc["n_wall_connections"] < 1:
        fail(f"cli scan-building: {bc}")
    take_counts()
    refuse_dev = "cuda:0" if on_card else device
    refused = os.path.join(out, "refused")
    cli(["refuse", refused, *streams, "--trajectories", *trajs, "--devices", "2x2", *flags],
        "refuse --devices 2x2", card, refuse_dev)
    for ri in range(2):
        t = np.load(os.path.join(refused, f"room{ri}", "trajectory.npz"))["poses"]
        if t.shape != (32, 4, 4) or not os.path.exists(os.path.join(refused, f"room{ri}",
                                                                     "planes.txt")):
            fail(f"cli refuse: room{ri} malformed")
    take_counts()

    # 8. two steps under the device trace; the occupancy against a CPU count
    from housescan_tpu_torch.kinfu.pipeline import kinfu_init, kinfu_step
    from housescan_tpu_torch.utils.metrics import device_trace, tsdf_occupancy

    res = int(flags[flags.index("--resolution") + 1]) if "--resolution" in flags else RES
    st = kinfu_init(intr, resolution=res, size_m=3.0, trunc=0.03, init_pose=poses[0],
                    device=device)
    for f in frames[:2]:
        st = kinfu_step(st, f, intr)
    trace_dir = os.path.join(out, "trace")
    with device_trace(trace_dir):
        # two steps: a trace can miss the kernels of its first moments
        for f in frames[2:4]:
            st = kinfu_step(st, f, intr)
        if on_card:
            torch.cuda.synchronize()
    with open(os.path.join(trace_dir, "trace.json")) as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name", "") for e in events if e.get("cat") == "kernel"}
    named = {k: any(sym in n for n in names) for k, sym in TRACE_KERNELS.items()}
    occ = tsdf_occupancy(st.volume)
    cpu_occ = int((st.volume.weight.cpu() > 0).sum()) / st.volume.weight.numel()
    print(f"# cli device trace of two steps: {len(events)} events, {len(names)} kernel names, "
          f"path kernels named {named}; occupancy {occ:.6f} (CPU count {cpu_occ:.6f}) [{card}]",
          flush=True)
    if (on_card and not all(named.values())) or occ != cpu_occ:
        fail(f"cli device trace: a kernel of the path is missing ({sorted(names)[:40]}), or the "
             "occupancy differs")

    # 9. state across a reload of the package; the step after it bit-identical
    from housescan_tpu_torch.devloop import get_state, reload_framework, store_state

    def clone(x):
        if isinstance(x, torch.Tensor):
            return x.clone()
        return type(x)(*map(clone, x)) if isinstance(x, tuple) else x

    before = kinfu_step(clone(st), frames[4], intr)
    store_state(sc)
    take_counts()
    n_reloaded = reload_framework()
    restored = get_state()
    pipeline = importlib.import_module("housescan_tpu_torch.kinfu.pipeline")
    after = pipeline.kinfu_step(clone(st), frames[4], intr)
    identical = all(torch.equal(getattr(before, k), getattr(after, k))
                    for k in ("pose", "planes", "model_maps")) and \
        torch.equal(before.volume.data, after.volume.data)
    print(f"# cli devloop: {n_reloaded} modules reloaded, state restored "
          f"{restored is sc}, the step after the reload bit-identical {identical} [{card}]",
          flush=True)
    if n_reloaded <= 10 or restored is not sc or pipeline.kinfu_step is kinfu_step or not identical:
        fail("cli devloop: the reload lost the state or changed the step")
    del st, before, after
    if on_card:
        torch.cuda.empty_cache()

    # 10. the multi-device dry run, its 4 devices one card
    dryrun = importlib.import_module("housescan_tpu_torch.parallel.dryrun")
    dry = dryrun.dryrun_multichip(4, device="cuda:0" if on_card else device)
    print(f"# cli dryrun_multichip(4): {json.dumps(dry)} [{card}]", flush=True)
    take_counts()
    if on_card and any(plain_runs.values()):
        fail(f"cli: plain versions ran {plain_runs}")
    print(f"# cli phase: live {json.dumps(live_stats)}; launches {json.dumps(launches)} [{card}]",
          flush=True)
    return launches


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
    if sys.argv[1:] == ["--mesh"]:
        mesh_probe(intr, poses, frames, device, card)
        return

    # 4. box-512 (packed): the gated orbit, then each kernel against its plain version
    errs, calls, bounds, sizes, st = box_kernels(intr, poses, frames, device, card)
    box_pose = st.pose[3, :3].cpu().numpy()
    del st
    torch.cuda.empty_cache()
    mark(4, t_start)

    # 5. split and unsplit integrates of the orbit
    same, observed = split_orbit_identical(intr, poses, frames, device, torch.int32)
    if not same:
        fail("the orbit integrated with the free split differs from the unsplit one")
    print(f"# split vs unsplit orbit (21 integrates at the true poses): bit-identical, "
          f"{observed} observed voxels", flush=True)
    mark(5, t_start)

    # 7. box-512-f32: the kernel path on the float32 volume
    f32, st = f32_kernels(intr, poses, frames, device, card)
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
    # launches: the kernel path's from the scan, K2's from the xla-480
    # orbit, K7's and K8's from the dense-512 run
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
    f32_times = time_f32(f32, card)
    print(f"# sizes: K4 {sizes['n_listed']} listed chunks (packed), {f32['tsdf_stream'][3]} "
          f"(float32); K5 {sizes['n_sb']} superblocks / {sizes['n_members']} member chunks "
          f"(packed), {f32['tsdf_free'][3]} / {f32['tsdf_free'][4]} (float32)", flush=True)
    del dense
    torch.cuda.empty_cache()
    mark(12, t_start)

    # 14. the curved world and the noisy, quantised world on the kernel path
    run_worlds(intr, poses, device, card)
    mark(14, t_start)

    # 15. two scanned rooms through the room stage, on the card and the CPU
    run_rooms(intr, device)
    mark(15, t_start)

    # 16. box-512-bf16: the kernel path on the bfloat16 volume
    rows += run_bf16(intr, poses, frames, device, card, f32_times, times, bounds)
    mark(16, t_start)

    # 17. sharded-512: the X-slab sharded step, 4 slabs on this card; the XLA path at 480^3
    sharded, slab_errs = run_sharded(intr, poses, frames, device, card, box_pose)
    for row in rows:
        if "@" not in row["name"]:
            row["launches_sharded"] = sharded[row["name"]]
        if row["name"] in slab_errs:
            row["max_abs_err_slab"] = slab_errs[row["name"]]
    mark(17, t_start)

    # 18. building: scan_building at Config() on two rooms, without and with the mesh
    run_building(intr, device, card)
    mark(18, t_start)

    # 19. the command line on the card, in this process
    cli_launches = run_cli(intr, poses, frames, card, rooms_dir=os.path.join(OUT, "rooms"))
    for row in rows:
        if "@" not in row["name"]:
            row["launches_cli"] = cli_launches[row["name"]]
    mark(19, t_start)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
