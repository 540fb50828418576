"""K3: every Gauss-Newton iteration of one ICP pyramid level.

Replaces ``housescan_tpu/ops/icp_pallas.py:_kernel`` (via
``icp_level_pallas``). Per iteration: linearised sub-pixel projective
association along the model-map gradients, distance and angle gates with
the adaptive tight -> wide widening, Huber point-to-plane residuals with
incidence weighting, the 29-scalar reduction (21 A, 6 b, sq, n_corr),
then the 6x6 solve of ``solve6.py`` and the pose update; early exit once
a healthy tight iteration's step norm drops below 1e-5.

Packed input rows (float32, ``kinfu/maps.pack_icp_inputs``): 0-2 live
vertex, 3-5 live normal (camera), 6-8 model vertex, 9-11 model normal
(world), 12 model valid, 13-15 d(model v)/du, 16-18 d(model v)/dv. Rows
and columns beyond the true image are zero.

CUDA kernel ``csrc/icp.cu``: ONE cooperative, persistent launch a level
(replacing the TPU grid (n_iters, n_bands), which ran in order with the
pose in SMEM). ``icp_plan`` cuts the level's pixels into one contiguous
slice per SM; each block copies its slice's 19 rows into shared memory
once (as many of its pixels as fit there; a larger slice reads the rest
from global memory every iteration) and runs every iteration from
there: its 30 partial sums (the 29
plus the visible-model count the gate needs) in a fixed order, one grid
sync, then every block sums all blocks' partials in double in the same
order and runs the gate state machine and the solve (``csrc/solve6.cuh``)
itself, so all blocks hold the same pose bit for bit and leave the loop
together. No float atomics, so the card repeats itself bit for bit; no
host synchronisation. The wrapper raises where the device cannot hold
even a warp's pixels a block in shared memory: there is no other form of
the kernel. Bound: the maps read once, 23 MB at 640 x 480 (7 us at 3.35
TB/s).
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import torch

from housescan_tpu_torch.kinfu.camera import Intrinsics
from housescan_tpu_torch.ops import cuda_lib
from housescan_tpu_torch.ops.solve6 import solve_twist_math
from housescan_tpu_torch.utils.metrics import GLOBAL_METRICS

N_ROWS = 19
BAND_H = 32
N_ACC = 29  # 21 A-upper + 6 b + sq + n_corr
N_PARTIAL = 30  # + the visible-model-pixel count
STATE_LEN = 32
PLAN_ALIGN = 32  # pixels a block: a multiple of this (16-byte rows, whole warps)
# Pixels a block takes at least (two a thread): below it a level's
# per-iteration grid sync and cross-block sums cost more than its pixels.
PLAN_MIN_SLICE = 1024
STATIC_SMEM = 4096  # the level kernel's static shared memory, rounded up
H100_SMEM_OPTIN = 232448  # shared memory an H100 block may opt into
MAX_STEP = 0.3  # largest twist per iteration (rad / m)
CORR_FRAC = 0.1  # correspondence collapse: n_corr < CORR_FRAC * visible model pixels
HUBER = 0.02


class IcpPlan(NamedTuple):
    blocks: int
    pixels_per_block: int
    shared_pixels: int  # of them held in shared memory (the first ones)
    smem_bytes: int  # dynamic (the held pixels' 19 rows) + static


def icp_plan(hp: int, wp: int, n_sms: int, max_smem: int = H100_SMEM_OPTIN) -> IcpPlan:
    """K3's grid for a (hp, wp) level on ``n_sms`` SMs: one contiguous slice
    of pixels per block, at most one block per SM and at least
    PLAN_MIN_SLICE pixels a block, the 19 rows of as many of each slice's
    pixels as ``max_smem`` bytes hold in shared memory (all of them at
    640 x 480 on an H100). Raises ValueError where ``max_smem`` cannot hold
    PLAN_ALIGN pixels."""
    n = hp * wp
    ppb = max(-(-n // n_sms), PLAN_MIN_SLICE)
    ppb = -(-ppb // PLAN_ALIGN) * PLAN_ALIGN
    room = (max_smem - STATIC_SMEM) // (N_ROWS * 4) // PLAN_ALIGN * PLAN_ALIGN
    if room < PLAN_ALIGN:
        raise ValueError(f"icp_level: {max_smem} bytes of shared memory a block cannot hold "
                         f"{PLAN_ALIGN} pixels' maps beside the kernel's {STATIC_SMEM}")
    held = min(ppb, room)
    return IcpPlan(-(-n // ppb), ppb, held, held * N_ROWS * 4 + STATIC_SMEM)


@functools.lru_cache(maxsize=None)
def _plan(hp: int, wp: int, device: int) -> IcpPlan:
    """``icp_plan`` on CUDA device ``device``, its slice resident on an SM."""
    with torch.cuda.device(device):
        n_sms, max_smem = cuda_lib.device_limits()
        plan = icp_plan(hp, wp, n_sms, max_smem)
        if cuda_lib.occupancy("icp_level", plan.shared_pixels)["icp_level_kernel"] < 1:
            raise ValueError(f"icp_level: a block holding {plan.shared_pixels} pixels cannot be "
                             f"resident on an SM")
    return plan


def _scalars(intr, window, dist_threshold, angle_threshold, damping, tight_threshold):
    """Entries 12-31 of the reference kernel's parameter row, the squared
    gates (17, 24) as given: a float, or a tensor taken in float32."""
    gate = 1.5 if window == 0 else float(window)
    corr_frac = CORR_FRAC
    if tight_threshold is None:
        tight_threshold = dist_threshold
        corr_frac = 0.0  # never widen (the gates are equal anyway)
    return [
        intr.fx, intr.fy, intr.cx, intr.cy,
        gate,
        dist_threshold,
        float(math.sin(angle_threshold)) ** 2,
        HUBER,
        damping,
        MAX_STEP,
        intr.height, intr.width,
        tight_threshold,
        corr_frac,
        0.0, 0.0, 0.0, 0.0, 0.0, 0.0,
    ]


GATES = (5, 12)  # the squared gates' places in _scalars


def _square(x):
    if isinstance(x, torch.Tensor):
        x = x.to(torch.float32)
    return x * x


def _params(prev_pose, intr, window, dist_threshold, angle_threshold, damping,
            tight_threshold):
    """The 32-float parameter row of the reference kernel."""
    sc = _scalars(intr, window, dist_threshold, angle_threshold, damping, tight_threshold)
    for g in GATES:
        sc[g] = _square(sc[g])
    return cuda_lib.f32_vector([prev_pose[:3, :3], prev_pose[3, :3], *sc], prev_pose.device)


def _level_sums(m, pose16, p, dist2, py, px, in_img):
    """The 29 reduction scalars of one iteration (reference kernel body)."""
    r00, r01, r02 = pose16[0], pose16[1], pose16[2]
    r10, r11, r12 = pose16[4], pose16[5], pose16[6]
    r20, r21, r22 = pose16[8], pose16[9], pose16[10]
    tx, ty, tz = pose16[12], pose16[13], pose16[14]
    pr00, pr01, pr02 = p[0], p[1], p[2]
    pr10, pr11, pr12 = p[3], p[4], p[5]
    pr20, pr21, pr22 = p[6], p[7], p[8]
    ptx, pty, ptz = p[9], p[10], p[11]
    fx, fy, cx, cy = p[12], p[13], p[14], p[15]
    gate, sin2, huber = p[16], p[18], p[19]
    h_valid, w_valid = p[22], p[23]
    (lvx, lvy, lvz, lnx, lny, lnz, mvx, mvy, mvz, mnx, mny, mnz, mok,
     gux, guy, guz, gvx, gvy, gvz) = m

    vwx = lvx * r00 + lvy * r10 + lvz * r20 + tx
    vwy = lvx * r01 + lvy * r11 + lvz * r21 + ty
    vwz = lvx * r02 + lvy * r12 + lvz * r22 + tz
    nwx = lnx * r00 + lny * r10 + lnz * r20
    nwy = lnx * r01 + lny * r11 + lnz * r21
    nwz = lnx * r02 + lny * r12 + lnz * r22
    live_ok = (lvz > 0.0) & (lnx * lnx + lny * lny + lnz * lnz > 0.25)

    dxw = vwx - ptx
    dyw = vwy - pty
    dzw = vwz - ptz
    xc = dxw * pr00 + dyw * pr01 + dzw * pr02
    yc = dxw * pr10 + dyw * pr11 + dzw * pr12
    zc = dxw * pr20 + dyw * pr21 + dzw * pr22
    safe_z = torch.where(zc > 1e-6, zc, 1.0)
    u = fx * xc / safe_z + cx
    v = fy * yc / safe_z + cy
    inb = (
        (zc > 1e-6)
        & (u >= 0.0)
        & (u <= w_valid - 1.0)
        & (v >= 0.0)
        & (v <= h_valid - 1.0)
    )
    du = u - px
    dv = v - py
    near = (du.abs() <= gate) & (dv.abs() <= gate)
    m_ok = (mok > 0.5) & near

    amx = mvx + gux * du + gvx * dv
    amy = mvy + guy * du + gvy * dv
    amz = mvz + guz * du + gvz * dv
    ddx = vwx - amx
    ddy = vwy - amy
    ddz = vwz - amz
    dist_ok = ddx * ddx + ddy * ddy + ddz * ddz < dist2
    cxn = nwy * mnz - nwz * mny
    cyn = nwz * mnx - nwx * mnz
    czn = nwx * mny - nwy * mnx
    angle_ok = cxn * cxn + cyn * cyn + czn * czn < sin2
    corr = live_ok & inb & m_ok & dist_ok & angle_ok & in_img

    g0 = vwy * mnz - vwz * mny
    g1 = vwz * mnx - vwx * mnz
    g2 = vwx * mny - vwy * mnx
    r_ = mnx * -ddx + mny * -ddy + mnz * -ddz
    w_rob = torch.clamp(huber / torch.clamp(r_.abs(), min=1e-9), max=1.0)
    rx = amx - ptx
    ry = amy - pty
    rz = amz - ptz
    rn = torch.sqrt(torch.clamp(rx * rx + ry * ry + rz * rz, min=1e-18))
    incidence = torch.clamp(-(mnx * rx + mny * ry + mnz * rz) / rn, min=0.0)
    w = corr.to(torch.float32) * w_rob * incidence * incidence

    wg = [w * g0, w * g1, w * g2, w * mnx, w * mny, w * mnz]
    wr = w * r_
    sums = []
    for i in range(6):
        for j in range(i, 6):
            sums.append((wg[i] * wg[j]).sum())
    for i in range(6):
        sums.append((wg[i] * wr).sum())
    sums.append((wr * wr).sum())
    sums.append(corr.to(torch.float32).sum())
    return sums


def icp_level_plain(packed, pose, prev_pose, intr, n_iters, window=0,
                    dist_threshold=0.10, angle_threshold=0.5236,
                    damping=3e-4, tight_threshold=None):
    """K3's plain version: the reference kernel's iteration loop, with
    every state update selected by ``torch.where`` on the converged flag
    (no host synchronisation)."""
    return _icp_level_plain(packed, pose, prev_pose, intr, n_iters, window, dist_threshold,
                            angle_threshold, damping, tight_threshold)[:3]


def _icp_level_plain(packed, pose, prev_pose, intr, n_iters, window, dist_threshold,
                     angle_threshold, damping, tight_threshold):
    """``icp_level_plain``'s (pose, rmse, n_corr), then the iterations run
    and the visible model pixels, as K3's state rows 18 and 20 hold them."""
    p = _params(prev_pose, intr, window, dist_threshold, angle_threshold,
                damping, tight_threshold)
    _, hp, wp = packed.shape
    dev = packed.device
    py = torch.arange(hp, dtype=torch.float32, device=dev)[:, None].expand(hp, wp)
    px = torch.arange(wp, dtype=torch.float32, device=dev)[None, :].expand(hp, wp)
    in_img = (py < p[22]) & (px < p[23])
    m = [packed[k] for k in range(N_ROWS)]
    mok_total = ((m[12] > 0.5) & in_img).to(torch.float32).sum()

    pose16 = [e for e in pose.reshape(16).to(torch.float32)]
    converged = torch.zeros((), dtype=torch.bool, device=dev)
    widen_until = torch.zeros((), dtype=torch.int32, device=dev)
    rmse = torch.zeros((), dtype=torch.float32, device=dev)
    n_corr = torch.zeros((), dtype=torch.float32, device=dev)
    iters_run = torch.zeros((), dtype=torch.int32, device=dev)
    for it in range(n_iters):
        dist2 = torch.where(it < widen_until, p[17], p[24])
        acc = _level_sums(m, pose16, p, dist2, py, px, in_img)
        a_flat = [None] * 36
        k = 0
        for i in range(6):
            for j in range(i, 6):
                a_flat[i * 6 + j] = acc[k]
                a_flat[j * 6 + i] = acc[k]
                k += 1
        res = solve_twist_math(a_flat, acc[21:27], pose16, p[20], p[21])
        norm = res[16]
        corr_it = acc[28]
        rmse_it = torch.sqrt(acc[27] / torch.clamp(corr_it, min=1.0))
        healthy = corr_it >= p[25] * mok_total
        was_tight = it >= widen_until
        trigger = ~healthy & was_tight
        widen_it = torch.where(
            trigger, torch.full_like(widen_until, it + 1 + (n_iters - it) // 2),
            widen_until,
        )
        conv_it = (norm <= 1e-5) & healthy & was_tight
        live = ~converged
        iters_run = iters_run + live.to(torch.int32)
        pose16 = [torch.where(live, res[i], pose16[i]) for i in range(16)]
        rmse = torch.where(live, rmse_it, rmse)
        n_corr = torch.where(live, corr_it, n_corr)
        widen_until = torch.where(live, widen_it, widen_until)
        converged = torch.where(live, conv_it, converged)
    return (torch.stack(pose16).reshape(4, 4), rmse, n_corr.to(torch.int32), iters_run,
            mok_total)


def icp_level(packed, pose, prev_pose, intr: Intrinsics, n_iters: int,
              window: int = 0, dist_threshold=0.10,
              angle_threshold: float = 0.5236, damping: float = 3e-4,
              tight_threshold=None):
    """K3: one pyramid level's GN iterations. Returns (pose (4, 4),
    rmse (), n_corr () int32), all on the input's device.

    ``tight_threshold`` enables the adaptive gate: tight by default,
    widening to ``dist_threshold`` when the correspondence count falls
    below CORR_FRAC of the visible model pixels, for half the
    remaining iterations. ``None`` = one fixed gate."""
    return _icp_level(packed, pose, prev_pose, intr, n_iters, window, dist_threshold,
                      angle_threshold, damping, tight_threshold)


def _icp_level(packed, pose, prev_pose, intr: Intrinsics, n_iters: int, window: int = 0,
               dist_threshold=0.10, angle_threshold: float = 0.5236, damping: float = 3e-4,
               tight_threshold=None, counters=None):
    """``icp_level``; with tracing on (``utils.metrics``), ``counters``,
    the names of the level's (iterations run, correspondences, visible
    model pixels), counts them: on the card K3's state rows 18, 22 and
    20, read only when the counters are drained."""
    _, hp, wp = packed.shape
    if hp % BAND_H or wp % 128 or packed.shape[0] != N_ROWS:
        raise ValueError(f"icp_level: packed must be (19, 32k, 128k), got {tuple(packed.shape)}")
    if tuple(prev_pose.shape) != (4, 4):
        raise ValueError(f"icp_level: prev_pose must be (4, 4), got {tuple(prev_pose.shape)}")
    if packed.device.type == "cpu":
        cuda_lib.plain_counts["icp_level"] += 1
        pose, rmse, n_corr, iters_run, visible = _icp_level_plain(
            packed, pose, prev_pose, intr, n_iters, window, dist_threshold, angle_threshold,
            damping, tight_threshold)
    else:
        state = icp_level_state(packed, pose, prev_pose, intr, n_iters, window, dist_threshold,
                                angle_threshold, damping, tight_threshold)
        pose, rmse, n_corr = state[:16].view(4, 4), state[16], state[22].view(torch.int32)
        iters_run = visible = None
    if counters is not None and GLOBAL_METRICS.tracing:
        if iters_run is None:
            iters_run, visible = state[18], state[20]
        for name, val in zip(counters, (iters_run, n_corr, visible)):
            GLOBAL_METRICS.count(name, val)
    return pose, rmse, n_corr


def icp_level_state(packed, pose, prev_pose, intr: Intrinsics, n_iters: int,
                    window: int = 0, dist_threshold=0.10,
                    angle_threshold: float = 0.5236, damping: float = 3e-4,
                    tight_threshold=None):
    """K3's launch on CUDA tensors: the level kernel's (32,) state (0-15
    pose, 16 rmse, 17 n_corr, 18 iterations run, 19 converged, 20
    visible-model pixels, 21 widen_until, 22 n_corr as int32 bits), with
    the blocks' partial sums of two iterations behind it. Raises
    ValueError where the device cannot hold the level's plan or
    ``prev_pose`` is not (4, 4).

    The host work is kept to a few calls: the parameter row's host values
    go to the kernel by value, and the previous pose and any gate given as
    a tensor are read on the device."""
    _, hp, wp = packed.shape
    dev = packed.device
    pose0 = pose.reshape(16).to(torch.float32)
    if tuple(prev_pose.shape) != (4, 4):
        raise ValueError(f"icp_level: prev_pose must be (4, 4), got {tuple(prev_pose.shape)}")
    prev = prev_pose.to(torch.float32).contiguous()  # read as row-major (4, 4)
    cuda_lib.require_cuda("icp_level", packed, pose0, prev)
    sc = _scalars(intr, window, dist_threshold, angle_threshold, damping, tight_threshold)
    gates = []
    for g in GATES:
        if isinstance(sc[g], torch.Tensor):
            t = sc[g].to(device=dev, dtype=torch.float32)
            gates.append(t)
            sc[g] = 0.0
        else:
            gates.append(None)
            sc[g] = sc[g] * sc[g]
    host = (ctypes.c_float * 32)(*([0.0] * 12 + sc))
    plan = _plan(hp, wp, dev.index)
    state = torch.empty(STATE_LEN + 2 * plan.blocks * N_PARTIAL, dtype=torch.float32, device=dev)
    cuda_lib.launch(
        "hs_icp_level", dev,
        packed.data_ptr(), hp, wp, plan.pixels_per_block, plan.shared_pixels, host,
        prev.data_ptr(),
        *(0 if t is None else t.data_ptr() for t in gates),
        pose0.data_ptr(), state.data_ptr(), n_iters,
    )
    cuda_lib.launch_counts["icp_level"] += 1
    return state
