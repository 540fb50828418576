"""Per-sub-block surface-plane fit (plain version).

Replaces the math of ``housescan_tpu/ops/planes_pallas.py``
(``plane_fields_for_block``, line 76). Three kernels run it, through the
device code ``csrc/planes.cuh`` (one warp per (8, 8, 8) sub-block): K4
for every listed chunk whose TSDF may hold a zero crossing
(``ops/tsdf_stream.py``), K7 for every chunk of the volume
(``ops/planes_cuda.extract_subblock_planes``) and K8 for whole (8, 8, R)
columns (``ops/tsdf_cuda.py``).

Fit: total least squares over the sub-block's TSDF zero-crossing points
(sub-voxel interpolated along +x, +y, +z), each weighted by
min(w_a, w_b, 8)/8; the normal is the smallest-eigenvalue eigenvector of
the centred crossing covariance by three ridge-regularised inverse power
iterations (Cramer 3x3 solves); the sign comes from the centred sdf
correlation over the |t| < 0.99 band. Valid iff >= 6 crossings,
lambda_min < 0.3 and lambda_mid > 0.1 (voxel^2).

Fields per sub-block: [nx, ny, nz, d, valid, count, subblock_id,
in-plane radius, centroid x, y, z, 0 (field 11: the integrate's
saturation/negative flags), lambda_min, 0, 0, 0]. The reference's hi/lo
bf16 split of the moment matmul is MXU precision engineering; here the
float32 moment terms are summed in float64 and rounded once, so that the
kernel and this version agree whatever their summation order.
"""

from __future__ import annotations

import torch

SUB_Z = 8
N_FIELDS = 16
CHUNK_Z = 128
NSUB_C = CHUNK_Z // SUB_Z
RIDGE = 1e-4
LAMBDA_MIN_MAX = 0.3
LAMBDA_MID_MIN = 0.1


def _alpha(t0, t1):
    denom = t0 - t1
    ok = denom.abs() > 1e-12
    return torch.clamp(
        torch.where(ok, t0 / torch.where(ok, denom, 1.0), 0.5), 0.0, 1.0
    )


def chunk_plane_fields(t, w, ci, cj, ck, vs, ox, oy, oz, nbx, nzc, min_count=6.0):
    """(B, 8, 8, 128) stored tsdf / weight of B chunks at chunk coords
    (ci, cj, ck) -> (B, N_FIELDS, NSUB_C) fields, under the chunk ids
    ((ci nbx + cj) nzc + ck) 16 + s of the persistent planes layout."""
    z_base = (ck * CHUNK_Z).to(torch.float32)
    sid_base = ((ci.to(torch.int64) * nbx + cj) * nzc + ck) * NSUB_C
    return plane_fields_plain(t, w, ci, cj, z_base, sid_base, vs, ox, oy, oz, min_count)


def plane_fields_plain(t, w, ci, cj, z_base, sid_base, vs, ox, oy, oz, min_count=6.0):
    """(B, 8, 8, nz) stored tsdf / weight of B blocks at x, y block coords
    (ci, cj) -> (B, N_FIELDS, nz / 8) fields. Sub-block s of block b starts
    at voxel z ``z_base[b] + 8 s`` and is called ``sid_base[b] + s``; the
    +z crossings run through the whole block (only its last slice is
    masked): a chunk for K4 and K7 (``chunk_plane_fields``), a whole
    column for K8."""
    dev = t.device
    f32 = torch.float32
    b, nz = t.shape[0], t.shape[3]
    nsub = nz // SUB_Z
    x = torch.arange(8, dtype=f32, device=dev).reshape(1, 8, 1, 1)
    iy = torch.arange(8, dtype=f32, device=dev).reshape(1, 1, 8, 1)
    zi = torch.arange(nz, device=dev).reshape(1, 1, 1, nz)
    z_f = zi.to(f32)
    zz = z_f - torch.floor(z_f / SUB_Z) * SUB_Z
    not_last_z = (zi < nz - 1).to(f32)
    not_last_y = (iy < 7.0).to(f32)
    not_last_x = (x < 7.0).to(f32)
    obs = w > 0.0

    def wt(wa, wb):
        return torch.clamp(torch.minimum(wa, wb), max=8.0) * 0.125

    def shifted(a, dim):
        # position k holds a[k + 1]; the last index reads itself (masked)
        idx = torch.clamp(torch.arange(a.shape[dim], device=dev) + 1, max=a.shape[dim] - 1)
        return a.index_select(dim, idx)

    def mask(tn, wn, keep):
        return (obs & (wn > 0.0) & ((t < 0) != (tn < 0))).to(f32) * keep

    t_z, w_z = shifted(t, 3), shifted(w, 3)
    t_y, w_y = shifted(t, 2), shifted(w, 2)
    t_x, w_x = shifted(t, 1), shifted(w, 1)
    fam = [
        (mask(t_z, w_z, not_last_z), wt(w, w_z), x, iy, zz + _alpha(t, t_z)),
        (mask(t_y, w_y, not_last_y), wt(w, w_y), x, iy + _alpha(t, t_y), zz),
        (mask(t_x, w_x, not_last_x), wt(w, w_x), x + _alpha(t, t_x), iy, zz),
    ]

    def ysum(v):  # (B, 8, 8, 128) -> (B, 8, 128): sum over iy, in float64
        return torch.broadcast_to(v, t.shape).to(torch.float64).sum(dim=2)

    rows = [None] * 11
    for mk, wgt, px, py, pz in fam:
        m = mk * wgt
        terms = [
            m, m * px, m * py, m * pz, m * px * px, m * py * py, m * pz * pz,
            m * px * py, m * px * pz, m * py * pz, mk,
        ]
        for r, term in enumerate(terms):
            s = ysum(term)
            rows[r] = s if rows[r] is None else rows[r] + s
    band = (obs & (t.abs() < 0.99)).to(f32)
    rows += [
        ysum(band), ysum(band * t), ysum(band * x), ysum(band * iy), ysum(band * zz),
        ysum(band * x * t), ysum(band * iy * t), ysum(band * zz * t),
    ]
    # (19, B, 8 ix, 128 z) -> per-sub-block sums. The float32 products
    # are summed in float64 and rounded once: E[p^2] - E[p]^2 cancels, and
    # a float32 sum's order would show in lambda_min at the 1e-5 level.
    seg = torch.stack(rows).reshape(19, b, 8, nsub, SUB_Z).sum(dim=-1)
    acc = seg.sum(dim=2).to(f32)

    cnt = acc[10]
    n0 = torch.clamp(acc[0], min=1e-6)
    mx = acc[1] / n0
    my = acc[2] / n0
    mz = acc[3] / n0
    cxx = torch.clamp(acc[4] / n0 - mx * mx, min=0.0)
    cyy = torch.clamp(acc[5] / n0 - my * my, min=0.0)
    czz = torch.clamp(acc[6] / n0 - mz * mz, min=0.0)
    cxy = acc[7] / n0 - mx * my
    cxz = acc[8] / n0 - mx * mz
    cyz = acc[9] / n0 - my * mz

    rxx = cxx + RIDGE
    ryy = cyy + RIDGE
    rzz = czz + RIDGE
    det = (
        rxx * (ryy * rzz - cyz * cyz)
        - cxy * (cxy * rzz - cyz * cxz)
        + cxz * (cxy * cyz - ryy * cxz)
    )
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

    seed_x = ((cxx <= cyy) & (cxx <= czz)).to(f32)
    seed_z = ((czz < cxx) & (czz < cyy)).to(f32)
    v, _ = inv_iter((seed_x, 1.0 - seed_x - seed_z, seed_z))
    v, _ = inv_iter(v)
    (nx_, ny_, nz_), growth = inv_iter(v)
    lam_min = torch.clamp(1.0 / torch.clamp(growth, min=1e-6) - RIDGE, min=0.0)
    ok_plane = lam_min < LAMBDA_MIN_MAX

    trace = cxx + cyy + czz
    px_ = ((cxx >= cyy) & (cxx >= czz)).to(f32)
    pz_ = ((czz > cxx) & (czz > cyy)).to(f32)
    py_ = 1.0 - px_ - pz_
    ux = cxx * px_ + cxy * py_ + cxz * pz_
    uy = cxy * px_ + cyy * py_ + cyz * pz_
    uz = cxz * px_ + cyz * py_ + czz * pz_
    un = torch.clamp(torch.sqrt(ux * ux + uy * uy + uz * uz), min=1e-20)
    ux, uy, uz = ux / un, uy / un, uz / un
    lam_max = (
        ux * (cxx * ux + cxy * uy + cxz * uz)
        + uy * (cxy * ux + cyy * uy + cyz * uz)
        + uz * (cxz * ux + cyz * uy + czz * uz)
    )
    lam_mid = torch.clamp(trace - lam_max - lam_min, min=0.0)
    ok_spread = lam_mid > LAMBDA_MID_MIN

    g0 = torch.clamp(acc[11], min=1.0)
    gs = acc[12] / g0
    gmx = acc[13] / g0
    gmy = acc[14] / g0
    gmz = acc[15] / g0
    gx_o = acc[16] / g0 - gmx * gs
    gy_o = acc[17] / g0 - gmy * gs
    gz_o = acc[18] / g0 - gmz * gs
    sign = torch.where(nx_ * gx_o + ny_ * gy_o + nz_ * gz_o < 0, -1.0, 1.0)
    nx_ = nx_ * sign
    ny_ = ny_ * sign
    nz_ = nz_ * sign

    sub = torch.arange(nsub, dtype=f32, device=dev)[None, :]
    ci_f = (ci * 8).to(f32)[:, None]
    cj_f = (cj * 8).to(f32)[:, None]
    wx = ox + (ci_f + mx + 0.5) * vs
    wy = oy + (cj_f + my + 0.5) * vs
    wz = oz + (z_base.to(f32)[:, None] + sub * SUB_Z + mz + 0.5) * vs
    d = nx_ * wx + ny_ * wy + nz_ * wz

    valid = (cnt >= min_count) & ok_plane & ok_spread
    vf = valid.to(f32)
    sub_id = sid_base.to(f32)[:, None] + sub
    r_inplane = 1.8 * torch.sqrt(torch.clamp(trace - lam_min, min=0.0))
    radius_w = (r_inplane + 1.5) * vs
    zero = torch.zeros_like(cnt)
    fields = [
        nx_ * vf, ny_ * vf, nz_ * vf, d * vf, vf, cnt, sub_id, radius_w,
        wx, wy, wz, zero, lam_min, zero, zero, zero,
    ]
    return torch.stack(fields, dim=1)
