"""The plain reference of one fusion step of the kernel path.

Plain PyTorch, imports nothing of the program. It is the arithmetic of
the port's kernel path (``kinfu_step(use_pallas=True)``) written out as
tensor code, operation for operation: the bilateral filter (K1), the
depth, vertex and normal pyramid, the model-map pyramid, every ICP level
(K3: linearised projective association, adaptive tight/wide gate, Huber
and incidence weights, the null-space-filtered 6x6 solve), the
tracking-loss gate, the chunk classification, the work-list integrate
with its plane refit (K4; the pure-free carve K5 is the FREE class of
the same list, which the program's split leaves bit for bit), the tile
plane raycast (K6) and its seam and skirt masks. The CUDA kernels are
built to reproduce exactly this arithmetic (``--fmad=false``), so the
only differences a sound program shows are the order of the ICP
reductions (the kernel sums in double in a fixed order, this code in
float32 as torch orders it).

Layouts: the volume is the float32 ``(2, R, R, R)`` array (tsdf, weight);
planes are ``(R/8, R/8, R/128, 16, 16)``; model maps ``(8, H, W)``
(depth, world vertex xyz, world normal xyz, valid). Poses are row-vector
camera-to-world 4x4 (``p_world = p_cam @ R + t``).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

F32 = torch.float32
BIG = 1.0e9


class Cam(NamedTuple):
    width: int
    height: int
    fx: float
    fy: float
    cx: float
    cy: float

    def level(self, lvl: int) -> "Cam":
        f = 1 << lvl
        return Cam(self.width // f, self.height // f, self.fx / f, self.fy / f,
                   self.cx / f, self.cy / f)


def vec(parts, device) -> torch.Tensor:
    """One float32 vector from floats and float32 tensors."""
    out = []
    for p in parts:
        if isinstance(p, torch.Tensor):
            out.append(p.reshape(-1).to(device=device, dtype=F32))
        else:
            out.append(torch.tensor([float(p)], dtype=F32, device=device))
    return torch.cat(out)


# ---------------------------------------------------------------- maps

MD_DEPTH, MD_VALID, MODEL_ROWS = 0, 7, 8


def halve(m):
    _, h, w = m.shape
    return m[:, : 2 * (h // 2): 2, : 2 * (w // 2): 2]


def shift2d(img, dy, dx):
    """Zero-filled shift: position p holds img[p - (dy, dx)]."""
    h, w = img.shape
    out = torch.zeros_like(img)
    if abs(dy) >= h or abs(dx) >= w:
        return out
    out[max(dy, 0): h + min(dy, 0), max(dx, 0): w + min(dx, 0)] = img[
        max(-dy, 0): h - max(dy, 0), max(-dx, 0): w - max(dx, 0)]
    return out


def bilateral(depth, radius=3, sigma_space=4.5, sigma_depth=0.03):
    valid = depth > 0
    inv_2ss = 0.5 / (sigma_space * sigma_space)
    inv_9sd2 = 1.0 / (9.0 * sigma_depth * sigma_depth)
    wsum = torch.zeros_like(depth)
    vsum = torch.zeros_like(depth)
    zero = torch.zeros_like(depth)
    for dy in range(-radius, radius + 1):
        for dx in range(-radius, radius + 1):
            s = shift2d(depth, dy, dx)
            ok = (s > 0) & valid
            dd = s - depth
            wr = torch.clamp(1.0 - dd * dd * inv_9sd2, min=0.0)
            w = math.exp(-(dy * dy + dx * dx) * inv_2ss) * wr * wr
            w = torch.where(ok, w, zero)
            wsum = wsum + w
            vsum = vsum + w * s
    out = torch.where(wsum > 0, vsum / torch.clamp(wsum, min=1e-12), zero)
    return torch.where(valid, out, zero)


def downsample_depth(depth, sigma_depth=0.03):
    center = depth
    wsum = torch.zeros_like(depth)
    vsum = torch.zeros_like(depth)
    zero = torch.zeros_like(depth)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            s = shift2d(depth, dy, dx)
            w = 1.0 if (dy == 0 and dx == 0) else 0.5
            ok = (s > 0) & ((s - center).abs() < 3 * sigma_depth)
            wv = torch.where(ok, w, zero)
            wsum = wsum + wv
            vsum = vsum + wv * s
    sm = torch.where((center > 0) & (wsum > 0), vsum / torch.clamp(wsum, min=1e-12), zero)
    return halve(sm[None])[0]


def vertices(depth, cam: Cam):
    h, w = depth.shape
    cols = torch.arange(w, dtype=depth.dtype, device=depth.device)[None, :]
    rows = torch.arange(h, dtype=depth.dtype, device=depth.device)[:, None]
    return torch.stack([(cols - cam.cx) / cam.fx * depth, (rows - cam.cy) / cam.fy * depth, depth])


def normals(v, max_depth_jump=0.08):
    vr, vl = torch.roll(v, -1, dims=2), torch.roll(v, 1, dims=2)
    vd, vu = torch.roll(v, -1, dims=1), torch.roll(v, 1, dims=1)
    du, dv = vr - vl, vd - vu
    nx = dv[1] * du[2] - dv[2] * du[1]
    ny = dv[2] * du[0] - dv[0] * du[2]
    nz = dv[0] * du[1] - dv[1] * du[0]
    n = torch.stack([nx, ny, nz])
    norm = torch.sqrt(nx * nx + ny * ny + nz * nz)
    z = v[2]
    cont = (((vr[2] - z).abs() < max_depth_jump) & ((vl[2] - z).abs() < max_depth_jump)
            & ((vd[2] - z).abs() < max_depth_jump) & ((vu[2] - z).abs() < max_depth_jump))
    valid = ((z > 0) & (vr[2] > 0) & (vl[2] > 0) & (vd[2] > 0) & (vu[2] > 0) & cont
             & (norm > 1e-12))
    n = n / torch.clamp(norm, min=1e-12)[None]
    flip = (n[0] * v[0] + n[1] * v[1] + n[2] * v[2]) > 0
    n = torch.where(flip[None], -n, n)
    return torch.where(valid[None], n, torch.zeros_like(n))


def live_pyramid(raw, cam: Cam, levels=3):
    depths = [bilateral(raw)]
    for _ in range(1, levels):
        depths.append(downsample_depth(depths[-1]))
    out = []
    for lvl, d in enumerate(depths):
        v = vertices(d, cam.level(lvl))
        out.append(torch.cat([v, normals(v)]))
    return out


def model_gradients(model):
    v = model[1:4]
    ok = model[MD_VALID] > 0.5

    def sh(m, dy, dx):
        return torch.roll(m, (-dy, -dx), (-2, -1))

    ok_u = sh(ok, 0, 1) & sh(ok, 0, -1)
    ok_v = sh(ok, 1, 0) & sh(ok, -1, 0)
    zero = torch.zeros_like(v)
    gu = torch.where(ok_u[None], 0.5 * (sh(v, 0, 1) - sh(v, 0, -1)), zero)
    gv = torch.where(ok_v[None], 0.5 * (sh(v, 1, 0) - sh(v, -1, 0)), zero)
    return torch.cat([gu, gv])


# ---------------------------------------------------------------- ICP

ICP_WINDOWS = (0, 2, 4)
ICP_DAMPINGS = (3e-4, 3e-3, 1e-2)
HUBER = 0.02
MAX_STEP = 0.3
CORR_FRAC = 0.1


def _sin_taylor(t):
    t2 = t * t
    return t * (1.0 + t2 * (-1.0 / 6 + t2 * (1.0 / 120 + t2 * (-1.0 / 5040 + t2 / 362880))))


def _cos_taylor(t):
    t2 = t * t
    return 1.0 + t2 * (-0.5 + t2 * (1.0 / 24 + t2 * (-1.0 / 720 + t2 * (1.0 / 40320))))


def solve_twist(a_flat, b_vec, pose_flat, damping, max_step, null_threshold=1e-2):
    """Iterated-Tikhonov x = (A + lam I)^-1 A (A + lam I)^-1 b (lam =
    max(damping, null_threshold) max|diag A|) by Cholesky, the non-finite
    and > 1e3 guards, the max-step clamp, Rodrigues by Taylor sin/cos,
    then pose @ increment: 16 pose entries and the step norm."""
    def a(i, j):
        return a_flat[i * 6 + j]

    where = torch.where
    scale = a(0, 0)
    for i in range(1, 6):
        scale = torch.maximum(scale, a(i, i).abs())
    scale = torch.clamp(scale, min=1e-12)
    lam = torch.clamp(damping, min=null_threshold) * scale
    L = [[None] * 6 for _ in range(6)]
    ok = None
    for i in range(6):
        for j in range(i + 1):
            s = a(i, j) + lam if i == j else a(i, j)
            for k in range(j):
                s = s - L[i][k] * L[j][k]
            if i == j:
                pos = s > 0.0
                ok = pos if ok is None else (ok & pos)
                L[i][j] = torch.sqrt(torch.clamp(s, min=1e-30))
            else:
                L[i][j] = s / L[j][j]

    def chol_solve(rhs):
        y = [None] * 6
        for i in range(6):
            s = rhs[i]
            for k in range(i):
                s = s - L[i][k] * y[k]
            y[i] = s / L[i][i]
        x = [None] * 6
        for i in range(5, -1, -1):
            s = y[i]
            for k in range(i + 1, 6):
                s = s - L[k][i] * x[k]
            x[i] = s / L[i][i]
        return x

    z = chol_solve(b_vec)
    az = []
    for i in range(6):
        s = a(i, 0) * z[0]
        for k in range(1, 6):
            s = s + a(i, k) * z[k]
        az.append(s)
    x = chol_solve(az)
    for i in range(6):
        ok = ok & torch.isfinite(x[i])
    x = [where(ok, xi, 0.0) for xi in x]
    nrm2 = x[0] * x[0]
    for i in range(1, 6):
        nrm2 = nrm2 + x[i] * x[i]
    nrm = torch.sqrt(torch.clamp(nrm2, min=1e-24))
    ok = ok & (nrm <= 1e3)
    x = [where(ok, xi, 0.0) for xi in x]
    nrm = where(ok, nrm, 0.0)
    fac = where(nrm > max_step, max_step / nrm, 1.0)
    x = [xi * fac for xi in x]
    wx, wy, wz, tx, ty, tz = x
    theta = torch.sqrt(torch.clamp(wx * wx + wy * wy + wz * wz, min=0.0))
    safe_t = torch.clamp(theta, min=1e-12)
    small = theta <= 1e-12
    kx = where(small, 0.0, wx / safe_t)
    ky = where(small, 0.0, wy / safe_t)
    kz = where(small, 0.0, wz / safe_t)
    s = _sin_taylor(theta)
    c = _cos_taylor(theta)
    one_c = 1.0 - c
    r00 = c + one_c * kx * kx
    r01 = s * (-kz) + one_c * kx * ky
    r02 = s * ky + one_c * kx * kz
    r10 = s * kz + one_c * ky * kx
    r11 = c + one_c * ky * ky
    r12 = s * (-kx) + one_c * ky * kz
    r20 = s * (-ky) + one_c * kz * kx
    r21 = s * kx + one_c * kz * ky
    r22 = c + one_c * kz * kz
    zero, one = torch.zeros_like(r00), torch.ones_like(r00)
    inc = [[r00, r10, r20, zero], [r01, r11, r21, zero], [r02, r12, r22, zero],
           [tx, ty, tz, one]]
    out = []
    for i in range(4):
        for j in range(4):
            s_ = pose_flat[i * 4] * inc[0][j]
            for k in range(1, 4):
                s_ = s_ + pose_flat[i * 4 + k] * inc[k][j]
            out.append(torch.where(ok, s_, pose_flat[i * 4 + j]))
    out.append(where(ok, nrm * fac, 0.0))
    return out


def _icp_params(prev_pose, cam: Cam, window, dist, angle, damping, tight):
    gate = 1.5 if window == 0 else float(window)
    sc = [cam.fx, cam.fy, cam.cx, cam.cy, gate, dist * dist, math.sin(angle) ** 2, HUBER,
          damping, MAX_STEP, cam.height, cam.width, tight.to(F32) * tight.to(F32), CORR_FRAC]
    sc += [0.0] * 6
    return vec([prev_pose[:3, :3], prev_pose[3, :3], *sc], prev_pose.device)


def _level_sums(m, pose16, p, dist2, py, px, in_img):
    r00, r01, r02 = pose16[0], pose16[1], pose16[2]
    r10, r11, r12 = pose16[4], pose16[5], pose16[6]
    r20, r21, r22 = pose16[8], pose16[9], pose16[10]
    tx, ty, tz = pose16[12], pose16[13], pose16[14]
    pr00, pr01, pr02, pr10, pr11, pr12, pr20, pr21, pr22 = (p[k] for k in range(9))
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
    dxw, dyw, dzw = vwx - ptx, vwy - pty, vwz - ptz
    xc = dxw * pr00 + dyw * pr01 + dzw * pr02
    yc = dxw * pr10 + dyw * pr11 + dzw * pr12
    zc = dxw * pr20 + dyw * pr21 + dzw * pr22
    safe_z = torch.where(zc > 1e-6, zc, 1.0)
    u = fx * xc / safe_z + cx
    v = fy * yc / safe_z + cy
    inb = (zc > 1e-6) & (u >= 0.0) & (u <= w_valid - 1.0) & (v >= 0.0) & (v <= h_valid - 1.0)
    du, dv = u - px, v - py
    near = (du.abs() <= gate) & (dv.abs() <= gate)
    m_ok = (mok > 0.5) & near
    amx = mvx + gux * du + gvx * dv
    amy = mvy + guy * du + gvy * dv
    amz = mvz + guz * du + gvz * dv
    ddx, ddy, ddz = vwx - amx, vwy - amy, vwz - amz
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
    rx, ry, rz = amx - ptx, amy - pty, amz - ptz
    rn = torch.sqrt(torch.clamp(rx * rx + ry * ry + rz * rz, min=1e-18))
    incidence = torch.clamp(-(mnx * rx + mny * ry + mnz * rz) / rn, min=0.0)
    w = corr.to(F32) * w_rob * incidence * incidence
    wg = [w * g0, w * g1, w * g2, w * mnx, w * mny, w * mnz]
    wr = w * r_
    sums = [(wg[i] * wg[j]).sum() for i in range(6) for j in range(i, 6)]
    sums += [(wg[i] * wr).sum() for i in range(6)]
    sums.append((wr * wr).sum())
    sums.append(corr.to(F32).sum())
    return sums


def icp_level(packed, pose, prev_pose, cam: Cam, n_iters, window, dist, angle, damping, tight):
    """Every Gauss-Newton iteration of one level: (pose, rmse, n_corr)."""
    p = _icp_params(prev_pose, cam, window, dist, angle, damping, tight)
    _, hp, wp = packed.shape
    dev = packed.device
    py = torch.arange(hp, dtype=F32, device=dev)[:, None].expand(hp, wp)
    px = torch.arange(wp, dtype=F32, device=dev)[None, :].expand(hp, wp)
    in_img = (py < p[22]) & (px < p[23])
    m = [packed[k] for k in range(19)]
    mok_total = ((m[12] > 0.5) & in_img).to(F32).sum()
    pose16 = list(pose.reshape(16).to(F32))
    converged = torch.zeros((), dtype=torch.bool, device=dev)
    widen_until = torch.zeros((), dtype=torch.int32, device=dev)
    rmse = torch.zeros((), dtype=F32, device=dev)
    n_corr = torch.zeros((), dtype=F32, device=dev)
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
        res = solve_twist(a_flat, acc[21:27], pose16, p[20], p[21])
        norm = res[16]
        corr_it = acc[28]
        rmse_it = torch.sqrt(acc[27] / torch.clamp(corr_it, min=1.0))
        healthy = corr_it >= p[25] * mok_total
        was_tight = it >= widen_until
        trigger = ~healthy & was_tight
        widen_it = torch.where(trigger, torch.full_like(widen_until, it + 1 + (n_iters - it) // 2),
                               widen_until)
        conv_it = (norm <= 1e-5) & healthy & was_tight
        live = ~converged
        pose16 = [torch.where(live, res[i], pose16[i]) for i in range(16)]
        rmse = torch.where(live, rmse_it, rmse)
        n_corr = torch.where(live, corr_it, n_corr)
        widen_until = torch.where(live, widen_it, widen_until)
        converged = torch.where(live, conv_it, converged)
    return torch.stack(pose16).reshape(4, 4), rmse, n_corr.to(torch.int32)


def pack_icp(live, model, band_h=32, lane=128):
    packed = torch.cat([live, model[1:MODEL_ROWS], model_gradients(model)])
    _, h, w = packed.shape
    hp, wp = -(-h // band_h) * band_h, -(-w // lane) * lane
    if (hp, wp) != (h, w):
        packed = F.pad(packed, (0, wp - w, 0, hp - h))
    return packed


def icp_track(live, models, start, cam: Cam, iterations, dist, angle, tight):
    n = len(live)
    pose = start
    dev = start.device
    rmse = torch.zeros((), dtype=F32, device=dev)
    n_corr = torch.zeros((), dtype=torch.int32, device=dev)
    for level in range(n - 1, -1, -1):
        iters = iterations[level] if len(iterations) == n else iterations[-1]
        if iters == 0:
            continue
        pose, lr, lc = icp_level(pack_icp(live[level], models[level]), pose, start,
                                 cam.level(level), iters, ICP_WINDOWS[level], dist, angle,
                                 ICP_DAMPINGS[level], tight)
        use = lc > 0
        rmse = torch.where(use, lr, rmse)
        n_corr = torch.where(use, lc, n_corr)
    return pose, rmse, n_corr


# ------------------------------------------------- chunk classification

CLS_FREE, CLS_BAND, CLS_REFINE = 0, 1, 3
WIN_V, WIN_U = 32, 128
CHUNK_Z = 128
SUB_Z = 8
N_FIELDS = 16
NSUB_C = CHUNK_Z // SUB_Z
SAT_W = 8.0
N_QUARTERS = 4
FIELD_SAT = 11


def _coarsen(m, pad_value, reduce_min):
    h, w = m.shape
    hp, wp = -(-h // 2) * 2, -(-w // 2) * 2
    mp = torch.full((hp, wp), pad_value, dtype=m.dtype, device=m.device)
    mp[:h, :w] = m
    r = mp.reshape(hp // 2, 2, wp // 2, 2)
    return r.amin(dim=(1, 3)) if reduce_min else r.amax(dim=(1, 3))


def _dilate_max(m):
    return F.max_pool2d(m[None, None], 3, stride=1, padding=1)[0, 0]


def _hiz(depth):
    h, w = depth.shape
    valid = depth > 0.0
    bh, bw = h // 8, w // 8
    blocks = depth[: bh * 8, : bw * 8].reshape(bh, 8, bw, 8)
    bval = valid[: bh * 8, : bw * 8].reshape(bh, 8, bw, 8)
    mins = [torch.where(bval, blocks, BIG).amin(dim=(1, 3))]
    maxs = [torch.where(bval, blocks, 0.0).amax(dim=(1, 3))]
    alls = [bval.to(F32).amin(dim=(1, 3))]
    for _ in range(4):
        mins.append(_coarsen(mins[-1], BIG, True))
        maxs.append(_coarsen(maxs[-1], 0.0, False))
        alls.append(_coarsen(alls[-1], BIG, True))
    dmin, dmax, val, offs, rows, cols = [], [], [], [], [], []
    off = 0
    for mn, mx, al in zip(mins, maxs, alls):
        r, c = mn.shape
        dmin.append((-_dilate_max(-mn)).reshape(-1))
        dmax.append(_dilate_max(mx).reshape(-1))
        val.append((-_dilate_max(-al)).reshape(-1))
        offs.append(off)
        rows.append(r)
        cols.append(c)
        off += r * c
    return torch.cat(dmin), torch.cat(dmax), torch.cat(val), offs, rows, cols


def _mip_h(h):
    return max(-(-(h + 1) // 8) * 8, WIN_V)


def _mip_w(w):
    return max(-(-(w + 1) // 128) * 128, WIN_U)


def worklist(depth, pose, cam: Cam, res, vs, origin, trunc, sat_quarters):
    """(listed descriptor rows (n, 7) [ci, cj, ck, cls, level, v0, u0]):
    every chunk the frame updates, in raster order."""
    nbx, nzc = res // 8, res // 128
    n = nbx * nbx * nzc
    dev = depth.device
    ids = torch.arange(n, dtype=torch.int32, device=dev)
    ci = ids // (nbx * nzc)
    cj = (ids // nzc) % nbx
    ck = ids % nzc
    x0 = origin[0] + ci.to(F32) * (8.0 * vs)
    y0 = origin[1] + cj.to(F32) * (8.0 * vs)
    z0 = origin[2] + ck.to(F32) * (128.0 * vs)
    rot, t = pose[:3, :3], pose[3, :3]
    w_img, h_img = float(cam.width), float(cam.height)

    def project_zplane(dzq):
        outs = []
        for dx in (0.0, 8.0):
            for dy in (0.0, 8.0):
                wx = x0 + dx * vs - t[0]
                wy = y0 + dy * vs - t[1]
                wz = z0 + dzq * vs - t[2]
                xc = wx * rot[0, 0] + wy * rot[0, 1] + wz * rot[0, 2]
                yc = wx * rot[1, 0] + wy * rot[1, 1] + wz * rot[1, 2]
                zc = wx * rot[2, 0] + wy * rot[2, 1] + wz * rot[2, 2]
                safe = torch.clamp(zc, min=1e-6)
                outs.append((cam.fx * xc / safe + cam.cx, cam.fy * yc / safe + cam.cy, zc))
        return outs

    zplanes = [project_zplane(dz) for dz in (0.0, 32.0, 64.0, 96.0, 128.0)]

    def full(v):
        return torch.full((n,), v, dtype=F32, device=dev)

    quarters = []
    for q in range(4):
        zmin, zmax, umin, umax, vmin, vmax = full(BIG), full(-BIG), full(BIG), full(-BIG), \
            full(BIG), full(-BIG)
        for uf, vf, zc in zplanes[q] + zplanes[q + 1]:
            zmin, zmax = torch.minimum(zmin, zc), torch.maximum(zmax, zc)
            umin, umax = torch.minimum(umin, uf), torch.maximum(umax, uf)
            vmin, vmax = torch.minimum(vmin, vf), torch.maximum(vmax, vf)
        clean = zmin > 1e-6
        out = (zmax <= 1e-6) | (clean & ((umax < 0.0) | (umin > w_img - 1.0) | (vmax < 0.0)
                                         | (vmin > h_img - 1.0)))
        quarters.append(dict(inc=~out, clean=clean, zmin=zmin, zmax=zmax, umin=umin, umax=umax,
                             vmin=vmin, vmax=vmax))
    any_inc = torch.zeros((n,), dtype=torch.bool, device=dev)
    for qd in quarters:
        any_inc = any_inc | qd["inc"]

    dmin_t, dmax_t, val_t, offs, rows_l, cols_l = _hiz(depth)
    stacked = torch.stack([dmin_t, dmax_t, val_t])
    offs_t = torch.tensor(offs, dtype=torch.int64, device=dev)
    rows_t = torch.tensor(rows_l, dtype=torch.int64, device=dev)
    cols_t = torch.tensor(cols_l, dtype=torch.int64, device=dev)
    dvalid = depth > 0.0
    any_valid, all_valid = dvalid.any(), dvalid.all()
    dmin_global = torch.where(dvalid, depth, BIG).amin()

    def fp_stats(umin_, umax_, vmin_, vmax_):
        cumin, cumax = torch.clamp(umin_, 0.0, w_img - 1.0), torch.clamp(umax_, 0.0, w_img - 1.0)
        cvmin, cvmax = torch.clamp(vmin_, 0.0, h_img - 1.0), torch.clamp(vmax_, 0.0, h_img - 1.0)
        span = torch.maximum(cumax - cumin, cvmax - cvmin)
        lvl = torch.clamp(torch.ceil(torch.log2(torch.clamp(span, min=1.0) / 8.0)), 0, 4).to(
            torch.int64)
        fit = span <= 8.0 * 16.0
        cell = 8.0 * torch.exp2(lvl.to(F32))
        cu, cv = (cumin + cumax) * 0.5, (cvmin + cvmax) * 0.5
        nr, nc = rows_t[lvl], cols_t[lvl]
        rr = torch.minimum(torch.clamp((cv / cell).to(torch.int32).to(torch.int64), min=0), nr - 1)
        cc = torch.minimum(torch.clamp((cu / cell).to(torch.int32).to(torch.int64), min=0), nc - 1)
        got = stacked[:, offs_t[lvl] + rr * nc + cc]
        return got[0], got[1], got[2] > 0.5, fit

    all_free, all_behind = any_inc, any_inc
    eff_any = torch.zeros((n,), dtype=torch.bool, device=dev)
    umin, umax, vmin, vmax = full(BIG), full(-BIG), full(BIG), full(-BIG)
    eff_clean = torch.ones((n,), dtype=torch.bool, device=dev)
    for qi, qd in enumerate(quarters):
        inc = qd["inc"]
        fq_min, fq_max, fq_all, fq_fit = fp_stats(qd["umin"], qd["umax"], qd["vmin"], qd["vmax"])
        tight = qd["clean"] & fq_fit
        behind_q = tight & (qd["zmin"] - trunc > fq_max)
        free_tight = (qd["zmax"] + trunc < fq_min) & (fq_max > 0.0) & fq_all
        free_global = (qd["zmax"] + trunc < dmin_global) & all_valid & any_valid
        free_q = torch.where(tight, free_tight, free_global)
        all_free = all_free & (~inc | free_q)
        all_behind = all_behind & (~inc | behind_q)
        behind_q = behind_q | (free_q & sat_quarters[:, qi])
        eff = inc & ~behind_q
        eff_any = eff_any | eff
        umin = torch.where(eff, torch.minimum(umin, qd["umin"]), umin)
        umax = torch.where(eff, torch.maximum(umax, qd["umax"]), umax)
        vmin = torch.where(eff, torch.minimum(vmin, qd["vmin"]), vmin)
        vmax = torch.where(eff, torch.maximum(vmax, qd["vmax"]), vmax)
        eff_clean = eff_clean & (~eff | qd["clean"])

    skip = ~any_inc | all_behind | ~eff_any
    free = any_inc & all_free
    clean = eff_any & eff_clean
    cls = torch.where(free, CLS_FREE, torch.where(clean, CLS_BAND, CLS_REFINE)).to(torch.int32)
    cumin, cumax = torch.clamp(umin, 0.0, w_img - 1.0), torch.clamp(umax, 0.0, w_img - 1.0)
    cvmin, cvmax = torch.clamp(vmin, 0.0, h_img - 1.0), torch.clamp(vmax, 0.0, h_img - 1.0)
    span_u, span_v = cumax - cumin, cvmax - cvmin
    fits0 = (span_v <= 22.0) & (span_u <= 60.0)
    fits1 = (span_v <= 44.0) & (span_u <= 120.0)
    fits2 = (span_v <= 88.0) & (span_u <= 240.0)
    level = torch.where(fits0, 0, torch.where(fits1, 1, torch.where(fits2, 2, 3)))
    level = torch.where(clean, level, 3).to(torch.int32)
    scale = torch.exp2(level.to(F32))
    h_l = [_mip_h(cam.height), _mip_h(-(-cam.height // 2)), _mip_h(-(-cam.height // 4))]
    w_l = [_mip_w(cam.width), _mip_w(-(-cam.width // 2)), _mip_w(-(-cam.width // 4))]
    lvl_i = level.to(torch.int64)
    hi = torch.tensor([[h - WIN_V for h in h_l] + [0], [w - WIN_U for w in w_l] + [0]],
                      dtype=torch.int32, device=dev)
    v0 = torch.minimum(torch.clamp(((cvmin / scale).to(torch.int32) - 1) & ~7, min=0), hi[0][lvl_i])
    u0 = torch.minimum(torch.clamp(((cumin / scale).to(torch.int32) - 1) & ~63, min=0),
                       hi[1][lvl_i])
    v0 = torch.where(level == 3, 0, v0)
    u0 = torch.where(level == 3, 0, u0)
    desc = torch.stack([ci, cj, ck, cls, level, v0.to(torch.int32), u0.to(torch.int32)], dim=1)
    return desc[~skip]


# ----------------------------------------------------- integrate + fit

def _pad_to(m, rows_mult, cols_to):
    h, w = m.shape
    hp = max(-(-(h + 1) // rows_mult) * rows_mult, WIN_V)
    wp = max(cols_to, -(-(w + 1) // 128) * 128, WIN_U)
    return F.pad(m[None, None], (0, wp - w, 0, hp - h), mode="replicate")[0, 0]


def depth_mips(depth):
    d0 = depth
    d1 = halve(d0[None])[0]
    d2 = halve(d1[None])[0]
    d3 = halve(d2[None])[0]
    m0 = _pad_to(d0, 8, -(-d0.shape[1] // 128) * 128)
    m1 = _pad_to(d1, 8, -(-d1.shape[1] // 128) * 128)
    m2 = _pad_to(d2, 8, -(-d2.shape[1] // 128) * 128)
    h3, w3 = d3.shape
    l3_v = max(-(-(h3 + 1) // 8) * 8, 8)
    l3_u = max(-(-(w3 + 1) // 128) * 128, 128)
    l3 = F.pad(d3[None, None], (0, l3_u - w3, 0, l3_v - h3), mode="replicate")[0, 0]
    return m0, m1, m2, l3


def _chunk_camera(ci, cj, ck, p):
    b = ci.shape[0]
    r00, r01, r02, r10, r11, r12, r20, r21, r22 = (p[k] for k in range(9))
    tx, ty, tz = p[9], p[10], p[11]
    vs = p[17]
    ox, oy, oz = p[18], p[19], p[20]
    ixf = torch.arange(8, dtype=F32, device=ci.device)
    zf = torch.arange(CHUNK_Z, dtype=F32, device=ci.device)
    xw = ox + ((ci * 8).to(F32).reshape(b, 1, 1, 1) + ixf.reshape(1, 8, 1, 1) + 0.5) * vs
    yw = oy + ((cj * 8).to(F32).reshape(b, 1, 1, 1) + ixf.reshape(1, 1, 8, 1) + 0.5) * vs
    zw = oz + ((ck * CHUNK_Z).to(F32).reshape(b, 1, 1, 1) + zf.reshape(1, 1, 1, CHUNK_Z) + 0.5) * vs
    dx, dy, dz = xw - tx, yw - ty, zw - tz
    return (dx * r00 + dy * r01 + dz * r02, dx * r10 + dy * r11 + dz * r12,
            dx * r20 + dy * r21 + dz * r22)


def _window_depth(mip, nrows, win_u, scale, v0, u0, uf, vf):
    shp = (-1, 1, 1, 1)
    u0f, v0f = u0.to(F32).reshape(shp), v0.to(F32).reshape(shp)
    uw = uf / scale - u0f
    uw = torch.round(uw * 256.0) * (1.0 / 256.0)
    vw = vf / scale - v0f
    support = (uw >= 0.0) & (uw <= float(win_u - 1)) & (vw >= 0.0) & (vw <= float(nrows - 1))
    c0f, r0f = torch.floor(uw), torch.floor(vw)
    wc0 = torch.clamp(1.0 - (uw - c0f).abs(), min=0.0)
    wc1 = torch.clamp(1.0 - (uw - (c0f + 1.0)).abs(), min=0.0)
    wr0 = torch.clamp(1.0 - (vw - r0f).abs(), min=0.0)
    wr1 = torch.clamp(1.0 - (vw - (r0f + 1.0)).abs(), min=0.0)
    c0 = torch.clamp(c0f, 0, win_u - 1).long()
    r0 = torch.clamp(r0f, 0, nrows - 1).long()
    c1 = torch.clamp(c0 + 1, max=win_u - 1)
    r1 = torch.clamp(r0 + 1, max=nrows - 1)
    rv, cu = v0.long().reshape(shp), u0.long().reshape(shp)
    win = mip[rv + torch.arange(nrows, device=mip.device).reshape(1, nrows, 1),
              cu + torch.arange(win_u, device=mip.device).reshape(1, 1, win_u)]
    all_valid = win.reshape(win.shape[0], -1).amin(dim=1) > 0.0

    def px(r, c):
        return mip[rv + r, cu + c]

    p00, p01, p10, p11 = px(r0, c0), px(r0, c1), px(r1, c0), px(r1, c1)
    num = (p00 * wc0 + p01 * wc1) * wr0 + (p10 * wc0 + p11 * wc1) * wr1
    q00, q01, q10, q11 = ((q > 0.0).to(F32) for q in (p00, p01, p10, p11))
    den = (q00 * wc0 + q01 * wc1) * wr0 + (q10 * wc0 + q11 * wc1) * wr1
    av = all_valid.reshape(shp)
    return torch.where(av, num, num / torch.clamp(den, min=1e-12)), support & (av | (den > 1e-6))


def _alpha(t0, t1):
    denom = t0 - t1
    ok = denom.abs() > 1e-12
    return torch.clamp(torch.where(ok, t0 / torch.where(ok, denom, 1.0), 0.5), 0.0, 1.0)


def plane_fields(t, w, ci, cj, ck, vs, ox, oy, oz, nbx, nzc, min_count=6.0):
    """(B, 8, 8, 128) tsdf / weight of B chunks -> (B, 16, 16) sub-block
    plane fields: total least squares over the zero-crossing points."""
    dev = t.device
    b, nz = t.shape[0], t.shape[3]
    nsub = nz // SUB_Z
    z_base = (ck * CHUNK_Z).to(F32)
    sid_base = ((ci.to(torch.int64) * nbx + cj) * nzc + ck) * NSUB_C
    x = torch.arange(8, dtype=F32, device=dev).reshape(1, 8, 1, 1)
    iy = torch.arange(8, dtype=F32, device=dev).reshape(1, 1, 8, 1)
    zi = torch.arange(nz, device=dev).reshape(1, 1, 1, nz)
    z_f = zi.to(F32)
    zz = z_f - torch.floor(z_f / SUB_Z) * SUB_Z
    not_last_z = (zi < nz - 1).to(F32)
    not_last_y = (iy < 7.0).to(F32)
    not_last_x = (x < 7.0).to(F32)
    obs = w > 0.0

    def wt(wa, wb):
        return torch.clamp(torch.minimum(wa, wb), max=8.0) * 0.125

    def shifted(a, dim):
        idx = torch.clamp(torch.arange(a.shape[dim], device=dev) + 1, max=a.shape[dim] - 1)
        return a.index_select(dim, idx)

    def mask(tn, wn, keep):
        return (obs & (wn > 0.0) & ((t < 0) != (tn < 0))).to(F32) * keep

    t_z, w_z = shifted(t, 3), shifted(w, 3)
    t_y, w_y = shifted(t, 2), shifted(w, 2)
    t_x, w_x = shifted(t, 1), shifted(w, 1)
    fam = [
        (mask(t_z, w_z, not_last_z), wt(w, w_z), x, iy, zz + _alpha(t, t_z)),
        (mask(t_y, w_y, not_last_y), wt(w, w_y), x, iy + _alpha(t, t_y), zz),
        (mask(t_x, w_x, not_last_x), wt(w, w_x), x + _alpha(t, t_x), iy, zz),
    ]

    def ysum(v):
        return torch.broadcast_to(v, t.shape).to(torch.float64).sum(dim=2)

    rows = [None] * 11
    for mk, wgt, px, py, pz in fam:
        m = mk * wgt
        terms = [m, m * px, m * py, m * pz, m * px * px, m * py * py, m * pz * pz,
                 m * px * py, m * px * pz, m * py * pz, mk]
        for r, term in enumerate(terms):
            s = ysum(term)
            rows[r] = s if rows[r] is None else rows[r] + s
    band = (obs & (t.abs() < 0.99)).to(F32)
    rows += [ysum(band), ysum(band * t), ysum(band * x), ysum(band * iy), ysum(band * zz),
             ysum(band * x * t), ysum(band * iy * t), ysum(band * zz * t)]
    acc = torch.stack(rows).reshape(19, b, 8, nsub, SUB_Z).sum(dim=-1).sum(dim=2).to(F32)

    cnt = acc[10]
    n0 = torch.clamp(acc[0], min=1e-6)
    mx, my, mz = acc[1] / n0, acc[2] / n0, acc[3] / n0
    cxx = torch.clamp(acc[4] / n0 - mx * mx, min=0.0)
    cyy = torch.clamp(acc[5] / n0 - my * my, min=0.0)
    czz = torch.clamp(acc[6] / n0 - mz * mz, min=0.0)
    cxy = acc[7] / n0 - mx * my
    cxz = acc[8] / n0 - mx * mz
    cyz = acc[9] / n0 - my * mz
    ridge = 1e-4
    rxx, ryy, rzz = cxx + ridge, cyy + ridge, czz + ridge
    det = (rxx * (ryy * rzz - cyz * cyz) - cxy * (cxy * rzz - cyz * cxz)
           + cxz * (cxy * cyz - ryy * cxz))
    safe_det = torch.where(det.abs() > 1e-18, det, 1.0)

    def inv_iter(v):
        bx, by, bz = v
        ux = (bx * (ryy * rzz - cyz * cyz) - cxy * (by * rzz - cyz * bz)
              + cxz * (by * cyz - ryy * bz)) / safe_det
        uy = (rxx * (by * rzz - bz * cyz) - bx * (cxy * rzz - cyz * cxz)
              + cxz * (cxy * bz - by * cxz)) / safe_det
        uz = (rxx * (ryy * bz - by * cyz) - cxy * (cxy * bz - by * cxz)
              + bx * (cxy * cyz - ryy * cxz)) / safe_det
        norm = torch.sqrt(ux * ux + uy * uy + uz * uz)
        safe_n = torch.clamp(norm, min=1e-20)
        return (ux / safe_n, uy / safe_n, uz / safe_n), norm

    seed_x = ((cxx <= cyy) & (cxx <= czz)).to(F32)
    seed_z = ((czz < cxx) & (czz < cyy)).to(F32)
    v, _ = inv_iter((seed_x, 1.0 - seed_x - seed_z, seed_z))
    v, _ = inv_iter(v)
    (nx_, ny_, nz_), growth = inv_iter(v)
    lam_min = torch.clamp(1.0 / torch.clamp(growth, min=1e-6) - ridge, min=0.0)
    ok_plane = lam_min < 0.3
    trace = cxx + cyy + czz
    px_ = ((cxx >= cyy) & (cxx >= czz)).to(F32)
    pz_ = ((czz > cxx) & (czz > cyy)).to(F32)
    py_ = 1.0 - px_ - pz_
    ux = cxx * px_ + cxy * py_ + cxz * pz_
    uy = cxy * px_ + cyy * py_ + cyz * pz_
    uz = cxz * px_ + cyz * py_ + czz * pz_
    un = torch.clamp(torch.sqrt(ux * ux + uy * uy + uz * uz), min=1e-20)
    ux, uy, uz = ux / un, uy / un, uz / un
    lam_max = (ux * (cxx * ux + cxy * uy + cxz * uz) + uy * (cxy * ux + cyy * uy + cyz * uz)
               + uz * (cxz * ux + cyz * uy + czz * uz))
    lam_mid = torch.clamp(trace - lam_max - lam_min, min=0.0)
    ok_spread = lam_mid > 0.1
    g0 = torch.clamp(acc[11], min=1.0)
    gs = acc[12] / g0
    gmx, gmy, gmz = acc[13] / g0, acc[14] / g0, acc[15] / g0
    gx_o = acc[16] / g0 - gmx * gs
    gy_o = acc[17] / g0 - gmy * gs
    gz_o = acc[18] / g0 - gmz * gs
    sign = torch.where(nx_ * gx_o + ny_ * gy_o + nz_ * gz_o < 0, -1.0, 1.0)
    nx_, ny_, nz_ = nx_ * sign, ny_ * sign, nz_ * sign
    sub = torch.arange(nsub, dtype=F32, device=dev)[None, :]
    wx = ox + ((ci * 8).to(F32)[:, None] + mx + 0.5) * vs
    wy = oy + ((cj * 8).to(F32)[:, None] + my + 0.5) * vs
    wz = oz + (z_base[:, None] + sub * SUB_Z + mz + 0.5) * vs
    d = nx_ * wx + ny_ * wy + nz_ * wz
    valid = (cnt >= min_count) & ok_plane & ok_spread
    vf = valid.to(F32)
    r_inplane = 1.8 * torch.sqrt(torch.clamp(trace - lam_min, min=0.0))
    zero = torch.zeros_like(cnt)
    return torch.stack([nx_ * vf, ny_ * vf, nz_ * vf, d * vf, vf, cnt,
                        sid_base.to(F32)[:, None] + sub, (r_inplane + 1.5) * vs,
                        wx, wy, wz, zero, lam_min, zero, zero, zero], dim=1)


def _integrate_chunks(vol, planes, d, mips, p, nbx, nzc):
    ci, cj, ck, cls, lvl, v0, u0 = (d[:, k] for k in range(7))
    b = d.shape[0]
    ar8 = torch.arange(8, device=ci.device)
    ar128 = torch.arange(CHUNK_Z, device=ci.device)
    cells = ((ci[:, None] * 8 + ar8).reshape(b, 8, 1, 1), (cj[:, None] * 8 + ar8).reshape(b, 1, 8, 1),
             (ck[:, None] * CHUNK_Z + ar128).reshape(b, 1, 1, CHUNK_Z))
    told, wold = vol[0][cells], vol[1][cells]
    fx, fy, cx, cy = p[12], p[13], p[14], p[15]
    trunc, vs = p[16], p[17]
    ox, oy, oz = p[18], p[19], p[20]
    max_weight, img_w, img_h = p[21], p[22], p[23]
    xc, yc, zc = _chunk_camera(ci, cj, ck, p)
    fxx, fyy = fx * xc, fy * yc
    iv_free = ((zc > 1e-6) & (fxx >= -cx * zc) & (fxx <= (img_w - 1.0 - cx) * zc)
               & (fyy >= -cy * zc) & (fyy <= (img_h - 1.0 - cy) * zc))
    safe_z = torch.clamp(zc, min=1e-6)
    uf = fx * xc / safe_z + cx
    vf = fy * yc / safe_z + cy
    iv = (zc > 1e-6) & (uf >= 0.0) & (uf <= img_w - 1.0) & (vf >= 0.0) & (vf <= img_h - 1.0)
    flat = (b, -1)
    bumin = torch.where(iv, uf, BIG).reshape(flat).amin(1)
    bumax = torch.where(iv, uf, -BIG).reshape(flat).amax(1)
    bvmin = torch.where(iv, vf, BIG).reshape(flat).amin(1)
    bvmax = torch.where(iv, vf, -BIG).reshape(flat).amax(1)
    span_u, span_v = bumax - bumin, bvmax - bvmin

    def fits(lv):
        s = float(1 << lv)
        return (span_v <= 22.0 * s) & (span_u <= 60.0 * s)

    lvl_r = torch.where(fits(0), 0, torch.where(fits(1), 1, torch.where(fits(2), 2, 3)))
    sc_r = torch.exp2(lvl_r.to(F32))
    m0, m1, m2, l3 = mips
    dev = vol.device
    h_sel = torch.tensor([m0.shape[0], m1.shape[0], m2.shape[0], m2.shape[0]], device=dev)[lvl_r]
    w_sel = torch.tensor([m0.shape[1], m1.shape[1], m2.shape[1], m2.shape[1]], device=dev)[lvl_r]
    v0_r = torch.minimum(torch.clamp(((bvmin / sc_r).to(torch.int32) - 1) & ~7, min=0), h_sel - WIN_V)
    u0_r = torch.minimum(torch.clamp(((bumin / sc_r).to(torch.int32) - 1) & ~63, min=0), w_sel - WIN_U)
    refine = cls == CLS_REFINE
    lvl_e = torch.where(refine, lvl_r, lvl).long()
    v0_e = torch.where(refine, v0_r.long(), v0.long())
    u0_e = torch.where(refine, u0_r.long(), u0.long())
    depth = torch.zeros_like(zc)
    has = torch.zeros_like(iv)
    band_like = cls != CLS_FREE
    for level, mip in enumerate(mips):
        sel = band_like & (lvl_e == level)
        if not bool(sel.any()):
            continue
        nrows, win_u = (WIN_V, WIN_U) if level < 3 else tuple(mip.shape)
        zero = torch.zeros_like(v0_e[sel])
        dl, hl = _window_depth(mip, nrows, win_u, float(1 << level),
                               v0_e[sel] if level < 3 else zero, u0_e[sel] if level < 3 else zero,
                               uf[sel], vf[sel])
        depth[sel] = dl
        has[sel] = hl
    free = (cls == CLS_FREE).reshape(b, 1, 1, 1)
    sdf = depth - zc
    update = torch.where(free, iv_free, iv & has & (sdf >= -trunc))
    sample = torch.where(free, 1.0, torch.clamp(sdf / trunc, -1.0, 1.0))
    wadd = update.to(F32)
    wnew = torch.minimum(wold + wadd, max_weight)
    denom = torch.clamp(wold + wadd, min=1.0)
    tcur = torch.where(update, (told * wold + sample * wadd) / denom, told)
    tst = tcur.to(vol.dtype)
    vol[0][cells] = tst
    vol[1][cells] = wnew.to(vol.dtype)
    t_stored = tst.to(F32)
    obs = wnew > 0.0
    mn_t = torch.where(obs, tcur, 1.0).reshape(flat).amin(1)
    mx_t = torch.where(obs, tcur, -1.0).reshape(flat).amax(1)
    may_cross = (mn_t < 0.0) & (mx_t >= 0.0)
    qshape = (b, 8, 8, N_QUARTERS, CHUNK_Z // N_QUARTERS)
    q_minw = torch.where(obs, wnew, BIG).reshape(qshape).amin(dim=(1, 2, 4))
    q_mint = torch.where(obs, tcur, 1.0).reshape(qshape).amin(dim=(1, 2, 4))
    q_maxw = wnew.reshape(qshape).amax(dim=(1, 2, 4))
    sat = ((q_minw >= SAT_W) & (q_mint > 0.999) & (q_maxw > 0.0)).to(F32)
    fields = plane_fields(t_stored, wnew, ci, cj, ck, vs, ox, oy, oz, nbx, nzc)
    fields = torch.where(may_cross.reshape(b, 1, 1), fields, 0.0)
    fields[:, FIELD_SAT, :N_QUARTERS] = sat
    fields[:, FIELD_SAT, N_QUARTERS] = (mn_t < 0.0).to(F32)
    fields[:, FIELD_SAT, N_QUARTERS + 1:] = 0.0
    planes[ci.long(), cj.long(), ck.long()] = fields


def integrate(vol, planes, depth, pose, cam: Cam, geom, max_weight, batch=512):
    """Integrate ``depth`` at ``pose`` into ``vol`` ((2, R, R, R): tsdf,
    weight) and refit the planes of every listed chunk, both in place.
    ``geom`` = (resolution, voxel size, origin (3,), trunc) as float32
    tensors on the volume's device (the resolution an int)."""
    res, vs, origin, trunc = geom
    sat_q = planes[:, :, :, FIELD_SAT, :N_QUARTERS].reshape(-1, N_QUARTERS) > 0.5
    rows = worklist(depth, pose, cam, res, vs, origin, trunc, sat_q).long()
    mips = depth_mips(depth)
    nbx, nzc = res // 8, res // CHUNK_Z
    p = vec([pose[:3, :3], pose[3, :3], cam.fx, cam.fy, cam.cx, cam.cy, trunc, vs, origin,
             max_weight, cam.width, cam.height, nbx, nzc, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0],
            depth.device)
    for s in range(0, rows.shape[0], batch):
        _integrate_chunks(vol, planes, rows[s: s + batch], mips, p, nbx, nzc)


# ------------------------------------------------------------ raycast

MAX_CT, SMALL_IMAGE_CT, CAND_CHUNK, N_PREP = 96, 384, 96, 16
MAX_PAIRS, MAX_VISIBLE = 16, 4096
CURV_CLIFF, CURV_TOL = 0.021, 0.25
EDGE_PX = 4


def tile_candidates(planes, pose, cam: Cam, vs, origin, res, z_min):
    nbx = planes.shape[0]
    nsub = res // SUB_Z
    nb = nbx * nbx * nsub
    n_bands = cam.height // 8
    n_ut = -(-cam.width // 128)
    n_tiles = n_bands * n_ut
    max_ct = MAX_CT if n_tiles >= 128 else max(SMALL_IMAGE_CT, MAX_CT)
    dev = planes.device

    def field(k):
        return planes[:, :, :, k, :].reshape(nb)

    valid = (field(4) > 0.5) & (field(12) <= CURV_CLIFF)
    occl = (~valid) & (field(5) >= 3.0)
    usable = valid | occl
    nx_f, ny_f, nz_f = field(0), field(1), field(2)
    ids = torch.arange(nb, device=dev)
    radius = vs * (float(32 + SUB_Z * SUB_Z // 4) ** 0.5 + 1.0)
    rot, t = pose[:3, :3], pose[3, :3]

    def geometry(sel_ids):
        bi = sel_ids // (nbx * nsub)
        bj = (sel_ids // nsub) % nbx
        bs = sel_ids % nsub
        dx = origin[0] + (bi * 8 + 4) * vs - t[0]
        dy = origin[1] + (bj * 8 + 4) * vs - t[1]
        dz = origin[2] + (bs * SUB_Z + SUB_Z // 2) * vs - t[2]
        xc = dx * rot[0, 0] + dy * rot[0, 1] + dz * rot[0, 2]
        yc = dx * rot[1, 0] + dy * rot[1, 1] + dz * rot[1, 2]
        z = dx * rot[2, 0] + dy * rot[2, 1] + dz * rot[2, 2]
        return dx, dy, dz, xc, yc, z

    dx, dy, dz, xc, yc, z = geometry(ids)
    in_front = z + radius > z_min
    facing = (nx_f * -dx + ny_f * -dy + nz_f * -dz) > -radius
    safe_z = torch.clamp(z - radius, min=0.05)
    u = cam.fx * xc / torch.clamp(z, min=1e-6) + cam.cx
    v = cam.fy * yc / torch.clamp(z, min=1e-6) + cam.cy
    pr_u, pr_v = cam.fx * radius / safe_z, cam.fy * radius / safe_z
    keep = (usable & in_front & (facing | occl) & (u + pr_u > 0) & (u - pr_u < cam.width)
            & (v + pr_v > 0) & (v - pr_v < cam.height))
    db_all = torch.clamp(z * (255.0 / 20.0), 0.0, 255.0).to(torch.int32)
    sentinel = 1 << 24
    nv = min(MAX_VISIBLE, nb)
    skeys, sel = torch.sort(torch.where(keep, db_all, sentinel), stable=True)
    skeys, sel = skeys[:nv], sel[:nv]
    keep_s = skeys < sentinel
    db = torch.where(keep_s, skeys, 255).to(torch.int64)
    _, _, _, xc_s, yc_s, z_s = geometry(sel)
    safe_z_s = torch.clamp(z_s - radius, min=0.05)
    u_s = cam.fx * xc_s / torch.clamp(z_s, min=1e-6) + cam.cx
    v_s = cam.fy * yc_s / torch.clamp(z_s, min=1e-6) + cam.cy
    pru_s, prv_s = cam.fx * radius / safe_z_s, cam.fy * radius / safe_z_s
    b0_s = torch.clamp(torch.floor((v_s - prv_s) / 8.0), 0, n_bands - 1).to(torch.int64)
    b1_s = torch.clamp(torch.ceil((v_s + prv_s) / 8.0), 0, n_bands - 1).to(torch.int64)
    t0_s = torch.clamp(torch.floor((u_s - pru_s) / 128.0), 0, n_ut - 1).to(torch.int64)
    t1_s = torch.clamp(torch.ceil((u_s + pru_s) / 128.0), 0, n_ut - 1).to(torch.int64)
    tspan_full = t1_s - t0_s + 1
    tspan = torch.clamp(tspan_full, max=4)
    t0_s = t0_s + torch.where(tspan_full > tspan, (tspan_full - tspan) // 2, 0)
    b_allow = torch.clamp(MAX_PAIRS // torch.clamp(tspan, min=1), min=1)
    bspan_full = b1_s - b0_s + 1
    bspan = torch.minimum(bspan_full, b_allow)
    b0_s = b0_s + torch.where(bspan_full > bspan, (bspan_full - bspan) // 2, 0)
    k = torch.arange(MAX_PAIRS, device=dev)
    kb = k[None, :] // tspan[:, None]
    kt = k[None, :] % torch.clamp(tspan[:, None], min=1)
    pair_ok = keep_s[:, None] & (kb < bspan[:, None])
    pair_tile = torch.where(pair_ok, (b0_s[:, None] + kb) * n_ut + (t0_s[:, None] + kt), n_tiles)
    pair_key = (pair_tile * 256 + db[:, None]).reshape(-1)
    pair_idx = torch.arange(nv, device=dev)[:, None].expand(nv, MAX_PAIRS).reshape(-1)
    sorted_keys, order = torch.sort(pair_key, stable=True)
    sorted_idx = pair_idx[order]
    start_all = torch.searchsorted(
        sorted_keys, torch.arange(n_tiles + 1, device=dev, dtype=sorted_keys.dtype) * 256)
    start = start_all[:-1]
    counts = start_all[1:] - start_all[:-1]
    slot = start[:, None] + torch.arange(max_ct, device=dev)[None, :]
    slot_c = torch.clamp(slot, 0, sorted_keys.shape[0] - 1)
    slot_ok = torch.arange(max_ct, device=dev)[None, :] < counts[:, None]
    slot_idx = sorted_idx[slot_c.reshape(-1)]
    stacked = torch.stack([nx_f, ny_f, nz_f, field(3), field(8), field(9), field(10),
                           field(7), field(6), occl.to(F32), field(12)])
    sel_f = stacked[:, sel]
    s_nx, s_ny, s_nz = sel_f[0], sel_f[1], sel_f[2]
    f_num = sel_f[3] - (s_nx * t[0] + s_ny * t[1] + s_nz * t[2])
    sag = 3.46 * torch.sqrt(torch.clamp(sel_f[10], min=0.0))
    shrink2 = torch.where(sel_f[9] > 0.5, 1.0,
                          torch.clamp(CURV_TOL / torch.clamp(sag, min=1e-9), 0.1225, 1.0))
    prep = torch.stack([s_nx, s_ny, s_nz, f_num, sel_f[4] - t[0], sel_f[5] - t[1],
                        sel_f[6] - t[2], sel_f[7] * sel_f[7] * shrink2, sel_f[8],
                        keep_s.to(F32), sel_f[9]])
    cand = prep[:, slot_idx].reshape(prep.shape[0], n_tiles, max_ct).permute(1, 2, 0)
    cand = F.pad(cand, (0, N_PREP - prep.shape[0]))
    return torch.where(slot_ok[..., None], cand, 0.0)


def raycast_raw(cand, pose, cam: Cam, z_min):
    """(9, H, W_pad) raw rows [depth, vertex xyz, normal xyz, block id,
    occluder event t]: each tile's nearest front-facing plane hit."""
    dev = cand.device
    n_tiles, max_ct, _ = cand.shape
    n_ut = -(-cam.width // 128)
    w_pad = n_ut * 128
    p = vec([pose[:3, :3], pose[3, :3], cam.fx, cam.fy, cam.cx, cam.cy, z_min, n_ut], dev)
    r00, r01, r02, r10, r11, r12, r20, r21, r22 = (p[k] for k in range(9))
    tx, ty, tz = p[9], p[10], p[11]
    fx, fy, cx, cy = p[12], p[13], p[14], p[15]
    zm = p[16]
    g = torch.arange(n_tiles, device=dev)
    rows = torch.arange(8, dtype=F32, device=dev).reshape(1, 1, 8, 1)
    cols = torch.arange(128, dtype=F32, device=dev).reshape(1, 1, 1, 128)
    u_pix = (g % n_ut * 128).to(F32).reshape(-1, 1, 1, 1) + cols
    v_pix = (g // n_ut * 8).to(F32).reshape(-1, 1, 1, 1) + rows
    dcx, dcy = (u_pix - cx) / fx, (v_pix - cy) / fy
    dwx = dcx * r00 + dcy * r10 + r20
    dwy = dcx * r01 + dcy * r11 + r21
    dwz = dcx * r02 + dcy * r12 + r22
    acc = None
    for k0 in range(0, max_ct, CAND_CHUNK):
        c = cand[:, k0: k0 + CAND_CHUNK]

        def col(f):
            return c[:, :, f].reshape(n_tiles, -1, 1, 1)

        nx, ny, nz, fnum = col(0), col(1), col(2), col(3)
        rx, ry, rz, rad2 = col(4), col(5), col(6), col(7)
        bid, ok, occf = col(8), col(9), col(10)
        den = nx * dwx + ny * dwy + nz * dwz
        safe = torch.where(den.abs() > 1e-9, den, -1e-9)
        tq = fnum / safe
        qx, qy, qz = tq * dwx - rx, tq * dwy - ry, tq * dwz - rz
        dist2 = qx * qx + qy * qy + qz * qz
        hit = (ok > 0.5) & (occf < 0.5) & (den < 0.0) & (dist2 <= rad2) & (tq > zm)
        tt = torch.where(hit, tq, BIG)
        best_t = tt.amin(dim=1, keepdim=True)
        d2 = dwx * dwx + dwy * dwy + dwz * dwz
        ts = (rx * dwx + ry * dwy + rz * dwz) / d2
        ox_, oy_, oz_ = ts * dwx - rx, ts * dwy - ry, ts * dwz - rz
        miss2 = ox_ * ox_ + oy_ * oy_ + oz_ * oz_
        hit_o = (ok > 0.5) & (occf > 0.5) & (miss2 <= rad2) & (ts > zm)
        o_c = torch.where(hit_o, ts, BIG).amin(dim=1, keepdim=True)
        win = hit & (tt <= best_t)
        bid_c = torch.where(win, bid, -1.0).amax(dim=1, keepdim=True)
        sel = win & (bid == bid_c)
        nx_c = torch.where(sel, nx, -BIG).amax(dim=1, keepdim=True)
        ny_c = torch.where(sel, ny, -BIG).amax(dim=1, keepdim=True)
        nz_c = torch.where(sel, nz, -BIG).amax(dim=1, keepdim=True)
        if acc is None:
            acc = [best_t, bid_c, nx_c, ny_c, nz_c, o_c]
            continue
        a_t, a_bid, a_nx, a_ny, a_nz, a_o = acc
        take = (best_t < a_t) | ((best_t == a_t) & (bid_c > a_bid))
        acc = [torch.where(take, best_t, a_t), torch.where(take, bid_c, a_bid),
               torch.where(take, nx_c, a_nx), torch.where(take, ny_c, a_ny),
               torch.where(take, nz_c, a_nz), torch.minimum(o_c, a_o)]
    best_t, bbid, bnx, bny, bnz, best_o = acc
    got = best_t < BIG
    tq1 = torch.where(got, best_t, 0.0)
    out = torch.cat([tq1, torch.where(got, tx + tq1 * dwx, 0.0), torch.where(got, ty + tq1 * dwy, 0.0),
                     torch.where(got, tz + tq1 * dwz, 0.0), torch.where(got, bnx, 0.0),
                     torch.where(got, bny, 0.0), torch.where(got, bnz, 0.0),
                     torch.where(got, bbid, -1.0), best_o], dim=1)
    n_bands = n_tiles // n_ut
    return out.reshape(n_bands, n_ut, 9, 8, 128).permute(2, 0, 3, 1, 4).reshape(9, n_bands * 8, w_pad)


def finalize_maps(raw, vs):
    depth = raw[MD_DEPTH]
    nrm = raw[4:7]
    bid = raw[7]
    valid = (depth > 0) & (raw[8] > depth - 2.0 * vs)
    same = valid
    for dim, sh in ((1, 1), (1, -1), (2, 1), (2, -1)):
        nb = torch.roll(raw, sh, dims=dim)
        dot = nrm[0] * nb[4] + nrm[1] * nb[5] + nrm[2] * nb[6]
        agree = (dot > 0.9986) & ((depth - nb[MD_DEPTH]).abs() < 0.08)
        same = same & ((nb[7] == bid) | agree)
    valid = same
    acc = depth
    dmax = depth
    for s in range(1, EDGE_PX + 1):
        acc = torch.maximum(acc, torch.roll(dmax, s, dims=0))
        acc = torch.maximum(acc, torch.roll(dmax, -s, dims=0))
    dmax = acc
    for s in range(1, EDGE_PX + 1):
        acc = torch.maximum(acc, torch.roll(dmax, s, dims=1))
        acc = torch.maximum(acc, torch.roll(dmax, -s, dims=1))
    valid = valid & (acc - depth <= 2.0 * vs)
    masked = torch.where(valid[None], raw, 0.0)
    return torch.cat([masked[:MD_VALID], valid[None].to(F32)])


def raycast(planes, pose, cam: Cam, geom, z_min):
    res, vs, origin, _ = geom
    cand = tile_candidates(planes, pose, cam, vs, origin, res, z_min)
    return finalize_maps(raycast_raw(cand, pose, cam, z_min)[:, :, : cam.width], vs)
