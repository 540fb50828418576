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

CUDA kernel ``csrc/icp.cu``. The TPU grid (n_iters, n_bands) ran in
order with the pose in SMEM; on the GPU each iteration is two launches
on the stream with no host synchronisation: (a) one thread per pixel
computes the residual and writes its block's 30 partial sums (the 29
plus the visible-model count the gate needs) to a scratch buffer; (b) one
block reduces the partials in a fixed order (in double), runs the gate
state machine and the solve (``csrc/solve6.cuh``) and updates the pose in
a device state buffer. Launches after convergence return at once. There
are no float atomics, so the card repeats itself bit for bit. Bound: (a)
reads the 19 x 4 B x 307 K pixels = 23 MB of the finest level per
iteration (~8 us at 3.35 TB/s, mostly L2-resident); (b) is a single
block's latency, ~10 us; so a level costs a few tens of microseconds per
iteration, dominated by launch and reduction latency.
"""

from __future__ import annotations

import math

import torch

from housescan_tpu_torch.kinfu.camera import Intrinsics
from housescan_tpu_torch.ops import cuda_lib
from housescan_tpu_torch.ops.solve6 import solve_twist_math

N_ROWS = 19
BAND_H = 32
N_ACC = 29  # 21 A-upper + 6 b + sq + n_corr
N_PARTIAL = 30  # + the visible-model-pixel count
ICP_BLOCK = 256  # threads per block of kernel (a), csrc/icp.cu
STATE_LEN = 32
MAX_STEP = 0.3  # largest twist per iteration (rad / m)
CORR_FRAC = 0.1  # correspondence collapse: n_corr < CORR_FRAC * visible model pixels
HUBER = 0.02


def _params(prev_pose, intr, window, dist_threshold, angle_threshold, damping,
            tight_threshold):
    """The 32-float parameter row of the reference kernel."""
    gate = 1.5 if window == 0 else float(window)
    corr_frac = CORR_FRAC
    if tight_threshold is None:
        tight_threshold = dist_threshold
        corr_frac = 0.0  # never widen (the gates are equal anyway)
    return cuda_lib.f32_vector(
        [
            prev_pose[:3, :3],
            prev_pose[3, :3],
            intr.fx, intr.fy, intr.cx, intr.cy,
            gate,
            dist_threshold * dist_threshold,
            float(math.sin(angle_threshold)) ** 2,
            HUBER,
            damping,
            MAX_STEP,
            intr.height, intr.width,
            tight_threshold * tight_threshold,
            corr_frac,
            0.0, 0.0, 0.0, 0.0, 0.0, 0.0,
        ],
        prev_pose.device,
    )


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
        pose16 = [torch.where(live, res[i], pose16[i]) for i in range(16)]
        rmse = torch.where(live, rmse_it, rmse)
        n_corr = torch.where(live, corr_it, n_corr)
        widen_until = torch.where(live, widen_it, widen_until)
        converged = torch.where(live, conv_it, converged)
    return torch.stack(pose16).reshape(4, 4), rmse, n_corr.to(torch.int32)


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
    _, hp, wp = packed.shape
    if hp % BAND_H or wp % 128 or packed.shape[0] != N_ROWS:
        raise ValueError(f"icp_level: packed must be (19, 32k, 128k), got {tuple(packed.shape)}")
    if packed.device.type == "cpu":
        cuda_lib.plain_counts["icp_level"] += 1
        return icp_level_plain(packed, pose, prev_pose, intr, n_iters, window,
                               dist_threshold, angle_threshold, damping,
                               tight_threshold)
    params = _params(prev_pose, intr, window, dist_threshold, angle_threshold,
                     damping, tight_threshold)
    pose0 = pose.reshape(16).to(torch.float32).contiguous()
    cuda_lib.require_cuda("icp_level", packed, params, pose0)
    if pose0.numel() != 16:
        raise ValueError("icp_level: pose must be 4x4")
    n_blocks = -(-(hp * wp) // ICP_BLOCK)
    state = torch.empty(STATE_LEN, dtype=torch.float32, device=packed.device)
    partials = torch.empty(n_blocks * N_PARTIAL, dtype=torch.float32, device=packed.device)
    lib = cuda_lib.load()
    rc = lib.hs_icp_level(
        packed.data_ptr(), hp, wp, params.data_ptr(), pose0.data_ptr(),
        state.data_ptr(), partials.data_ptr(), n_iters, cuda_lib.stream_ptr(),
    )
    cuda_lib.check(rc, "hs_icp_level")
    cuda_lib.launch_counts["icp_level"] += 1
    return state[:16].reshape(4, 4), state[16], state[17].to(torch.int32)
