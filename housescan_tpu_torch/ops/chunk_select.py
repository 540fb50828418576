"""Chunk classification prepass of the streaming TSDF integrate.

Classifies every (8, 8, 128) chunk without touching the volume:

  * the corners of each chunk's four z-quarters are projected; their
    clipped image bbox bounds every voxel's footprint;
  * footprint depth min/max come from a 3x3-dilated min/max mip pyramid
    of the depth image (one cell read per quarter);
  * chunks classify SKIP (out of frustum, fully behind the surface,
    projecting only to invalid depth, or free and saturated), FREE
    (confidently in front of all valid depth), BAND (exact depth needed,
    footprint bounded) or REFINE (a quarter straddles the camera plane:
    the kernel recomputes the bbox per voxel). All tests err toward BAND.

The reference packs two chunks per work-list entry into 14-bit half
descriptors for the TPU's grid; this port lists single chunks as decoded
descriptor rows (ci, cj, ck, class, level, v0, u0). Every chunk the
reference updates is listed with the same descriptor; unlisted chunks
keep their volume data and planes bit-identical. X-pairing is not
ported.

``free_split=True`` also splits off the pure-free superblocks
(``FreeWorkList``): (32, 32, 128)-voxel groups of 4 x 4 chunks whose
every listed chunk is FREE and holds no observed negative tsdf. Their
member chunks leave the main list and go to the free carve (K5,
``ops/tsdf_stream.py``).

``build_worklist`` is the plain version, on any device. K9
(``launch_chunk_select``, ``csrc/chunk_select.cu``) computes the same
lists on the card, bit for bit, in three launches: the depth pyramid, a
thread a chunk, the stable partition. The reference has no kernel here
(its prepass is XLA array code); the plain version costs about 1,500
small tensor operations a step, whose host dispatch bounded the fusion
step. K9 reads the saturation and negative flags from planes field 11
and its host values from ``ops/tsdf_stream._stream_params``' vector.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from housescan_tpu_torch.kinfu.camera import Intrinsics
from housescan_tpu_torch.ops import cuda_lib
from housescan_tpu_torch.ops.cuda_lib import host_tensor
from housescan_tpu_torch.ops.planes import N_FIELDS, NSUB_C

BIG = 1.0e9
CLS_FREE = 0
CLS_BAND = 1
CLS_REFINE = 3

# Band-window geometry (matches ops/tsdf_stream.py).
WIN_V = 32
WIN_U = 128


class WorkList(NamedTuple):
    """Listed chunks first (raster order), then the skipped ones."""

    desc: torch.Tensor  # (n_chunks, 8) int32 rows [ci, cj, ck, cls, level, v0, u0, 0]
    count: torch.Tensor  # (1,) int32 number of listed chunks


class FreeWorkList(NamedTuple):
    """Pure-free superblocks, listed ones first in raster order; the
    padding repeats the last listed entry (all zeros when none is).

    A superblock is (32, 32, 128) voxels: chunks (4 bi + qi, 4 bj + qj,
    bk) for qi, qj in 0..3; bit qi * 4 + qj of ``bitmap`` marks a member
    chunk the free carve updates."""

    bitmap: torch.Tensor  # (n_sb,) int32 16 member bits
    count: torch.Tensor  # (1,) int32 listed superblocks, at least 1
    bi: torch.Tensor  # (n_sb,) int32 superblock x index (32-voxel units)
    bj: torch.Tensor  # (n_sb,) int32 superblock y index
    bk: torch.Tensor  # (n_sb,) int32 chunk z index


def _coarsen(m: torch.Tensor, pad_value: float, reduce_min: bool) -> torch.Tensor:
    h, w = m.shape
    hp, wp = -(-h // 2) * 2, -(-w // 2) * 2
    mp = torch.full((hp, wp), pad_value, dtype=m.dtype, device=m.device)
    mp[:h, :w] = m
    r = mp.reshape(hp // 2, 2, wp // 2, 2)
    return r.amin(dim=(1, 3)) if reduce_min else r.amax(dim=(1, 3))


def _dilate3_max(m: torch.Tensor) -> torch.Tensor:
    return F.max_pool2d(m[None, None], 3, stride=1, padding=1)[0, 0]


def _dilate3_min(m: torch.Tensor) -> torch.Tensor:
    return -_dilate3_max(-m)


def build_hiz(depth: torch.Tensor):
    """Dilated min/max/valid depth pyramid, flattened: level l spans
    table[offsets[l] : offsets[l] + rows[l]*cols[l]], cell 8 * 2**l px."""
    h, w = depth.shape
    valid = depth > 0.0
    bh, bw = h // 8, w // 8
    blocks = depth[: bh * 8, : bw * 8].reshape(bh, 8, bw, 8)
    bval = valid[: bh * 8, : bw * 8].reshape(bh, 8, bw, 8)
    bmin = torch.where(bval, blocks, BIG).amin(dim=(1, 3))
    bmax = torch.where(bval, blocks, 0.0).amax(dim=(1, 3))
    ball = bval.to(torch.float32).amin(dim=(1, 3))

    mins, maxs, alls = [bmin], [bmax], [ball]
    for _ in range(4):
        mins.append(_coarsen(mins[-1], BIG, True))
        maxs.append(_coarsen(maxs[-1], 0.0, False))
        alls.append(_coarsen(alls[-1], BIG, True))

    dmin_t, dmax_t, val_t, offs, rows, cols = [], [], [], [], [], []
    off = 0
    for mn, mx, al in zip(mins, maxs, alls):
        r, c = mn.shape
        dmin_t.append(_dilate3_min(mn).reshape(-1))
        dmax_t.append(_dilate3_max(mx).reshape(-1))
        val_t.append(_dilate3_min(al).reshape(-1))
        offs.append(off)
        rows.append(r)
        cols.append(c)
        off += r * c
    return torch.cat(dmin_t), torch.cat(dmax_t), torch.cat(val_t), offs, rows, cols


def build_worklist(
    depth: torch.Tensor,
    pose: torch.Tensor,
    intr: Intrinsics,
    resolution,
    voxel_size: torch.Tensor,
    origin: torch.Tensor,
    trunc: torch.Tensor,
    sat_quarters: torch.Tensor = None,
    block_x0: int = 0,
    neg_flags: torch.Tensor = None,
    free_split: bool = False,
):
    """Classify all chunks and list the non-SKIP ones.

    ``resolution`` is an int (a cubic volume) or the (nx, ny, nz) dims of
    an X-slab; ``origin`` is then the whole volume's origin and
    ``block_x0`` the slab's first global X block: the chunk corners are
    at ``origin + (ci + block_x0) 8 vs``, the whole volume's floats. The
    listed ci and the free list's bi stay slab-local.

    ``sat_quarters`` ((n, 4) bool, chunk raster order) marks z-quarters
    whose free space is saturated (planes field 11): a free + saturated
    quarter counts as behind. With ``free_split`` the result is
    ``(WorkList, FreeWorkList or None)``: the split needs x and y chunk
    counts divisible by 4, and ``neg_flags`` ((n,) bool, planes field 11
    column 4) excludes chunks holding an observed negative tsdf."""
    dims = (resolution,) * 3 if isinstance(resolution, int) else tuple(int(d) for d in resolution)
    nbx_x, nbx_y, nzc = dims[0] // 8, dims[1] // 8, dims[2] // 128
    n = nbx_x * nbx_y * nzc
    dev = depth.device
    f32 = torch.float32

    ids = torch.arange(n, dtype=torch.int32, device=dev)
    ci = ids // (nbx_y * nzc)
    cj = (ids // nzc) % nbx_y
    ck = ids % nzc

    vs = voxel_size
    x0 = origin[0] + (ci + block_x0).to(f32) * (8.0 * vs)
    y0 = origin[1] + cj.to(f32) * (8.0 * vs)
    z0 = origin[2] + ck.to(f32) * (128.0 * vs)

    rot = pose[:3, :3]
    t = pose[3, :3]
    w_img = float(intr.width)
    h_img = float(intr.height)

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
                uf = intr.fx * xc / safe + intr.cx
                vf = intr.fy * yc / safe + intr.cy
                outs.append((uf, vf, zc))
        return outs

    zplanes = [project_zplane(dz) for dz in (0.0, 32.0, 64.0, 96.0, 128.0)]

    def full(v):
        return torch.full((n,), v, dtype=f32, device=dev)

    quarters = []
    for q in range(4):
        qzmin, qzmax, qumin, qumax, qvmin, qvmax = (
            full(BIG), full(-BIG), full(BIG), full(-BIG), full(BIG), full(-BIG)
        )
        for uf, vf, zc in zplanes[q] + zplanes[q + 1]:
            qzmin = torch.minimum(qzmin, zc)
            qzmax = torch.maximum(qzmax, zc)
            qumin = torch.minimum(qumin, uf)
            qumax = torch.maximum(qumax, uf)
            qvmin = torch.minimum(qvmin, vf)
            qvmax = torch.maximum(qvmax, vf)
        qclean = qzmin > 1e-6
        q_out = (qzmax <= 1e-6) | (
            qclean
            & ((qumax < 0.0) | (qumin > w_img - 1.0) | (qvmax < 0.0) | (qvmin > h_img - 1.0))
        )
        quarters.append(
            dict(inc=~q_out, clean=qclean, zmin=qzmin, zmax=qzmax,
                 umin=qumin, umax=qumax, vmin=qvmin, vmax=qvmax)
        )

    any_included = torch.zeros((n,), dtype=torch.bool, device=dev)
    for qd in quarters:
        any_included = any_included | qd["inc"]
    out_frustum = ~any_included

    dmin_t, dmax_t, val_t, offs, rows_t, cols_t = build_hiz(depth)
    stacked = torch.stack([dmin_t, dmax_t, val_t], dim=0)
    offs_t, rows_tt, cols_tt = host_tensor([offs, rows_t, cols_t], torch.int64, dev)

    dvalid = depth > 0.0
    any_valid = dvalid.any()
    all_img_valid = dvalid.all()
    dmin_global = torch.where(dvalid, depth, BIG).amin()

    def fp_stats(umin_, umax_, vmin_, vmax_):
        cumin = torch.clamp(umin_, 0.0, w_img - 1.0)
        cumax = torch.clamp(umax_, 0.0, w_img - 1.0)
        cvmin = torch.clamp(vmin_, 0.0, h_img - 1.0)
        cvmax = torch.clamp(vmax_, 0.0, h_img - 1.0)
        span = torch.maximum(cumax - cumin, cvmax - cvmin)
        lvl = torch.clamp(
            torch.ceil(torch.log2(torch.clamp(span, min=1.0) / 8.0)), 0, 4
        ).to(torch.int64)
        fit = span <= 8.0 * 16.0
        cell = 8.0 * torch.exp2(lvl.to(f32))
        cu = (cumin + cumax) * 0.5
        cv = (cvmin + cvmax) * 0.5
        nr = rows_tt[lvl]
        nc = cols_tt[lvl]
        rr = torch.minimum(torch.clamp((cv / cell).to(torch.int32).to(torch.int64), min=0), nr - 1)
        cc = torch.minimum(torch.clamp((cu / cell).to(torch.int32).to(torch.int64), min=0), nc - 1)
        flat = offs_t[lvl] + rr * nc + cc
        got = stacked[:, flat]
        return got[0], got[1], got[2] > 0.5, fit

    all_free = any_included
    all_behind = any_included
    eff_any = torch.zeros((n,), dtype=torch.bool, device=dev)
    umin, umax, vmin, vmax = full(BIG), full(-BIG), full(BIG), full(-BIG)
    eff_clean = torch.ones((n,), dtype=torch.bool, device=dev)
    for qi, qd in enumerate(quarters):
        inc = qd["inc"]
        fq_min, fq_max, fq_all, fq_fit = fp_stats(qd["umin"], qd["umax"], qd["vmin"], qd["vmax"])
        tight = qd["clean"] & fq_fit
        behind_q = tight & (qd["zmin"] - trunc > fq_max)
        free_tight = (qd["zmax"] + trunc < fq_min) & (fq_max > 0.0) & fq_all
        free_global = (qd["zmax"] + trunc < dmin_global) & all_img_valid & any_valid
        free_q = torch.where(tight, free_tight, free_global)
        all_free = all_free & (~inc | free_q)
        all_behind = all_behind & (~inc | behind_q)
        if sat_quarters is not None:
            behind_q = behind_q | (free_q & sat_quarters[:, qi])
        eff = inc & ~behind_q
        eff_any = eff_any | eff
        umin = torch.where(eff, torch.minimum(umin, qd["umin"]), umin)
        umax = torch.where(eff, torch.maximum(umax, qd["umax"]), umax)
        vmin = torch.where(eff, torch.minimum(vmin, qd["vmin"]), vmin)
        vmax = torch.where(eff, torch.maximum(vmax, qd["vmax"]), vmax)
        eff_clean = eff_clean & (~eff | qd["clean"])

    skip = out_frustum | all_behind | ~eff_any
    free = any_included & all_free
    clean = eff_any & eff_clean
    cls = torch.where(
        free, CLS_FREE, torch.where(clean, CLS_BAND, CLS_REFINE)
    ).to(torch.int32)

    free_wl = None
    if free_split and nbx_x % 4 == 0 and nbx_y % 4 == 0:
        free_wl, in_free = _free_superblocks(free, skip, neg_flags, nbx_x, nbx_y, nzc)
        skip = skip | in_free  # member chunks leave the main list

    # Band window: level l fits iff span_v <= 22*2^l and span_u <= 60*2^l
    # after aligning the origin down (rows to 8, cols to 64).
    cumin = torch.clamp(umin, 0.0, w_img - 1.0)
    cumax = torch.clamp(umax, 0.0, w_img - 1.0)
    cvmin = torch.clamp(vmin, 0.0, h_img - 1.0)
    cvmax = torch.clamp(vmax, 0.0, h_img - 1.0)
    span_u = cumax - cumin
    span_v = cvmax - cvmin
    fits0 = (span_v <= 22.0) & (span_u <= 60.0)
    fits1 = (span_v <= 44.0) & (span_u <= 120.0)
    fits2 = (span_v <= 88.0) & (span_u <= 240.0)
    level = torch.where(fits0, 0, torch.where(fits1, 1, torch.where(fits2, 2, 3)))
    level = torch.where(clean, level, 3).to(torch.int32)
    scale = torch.exp2(level.to(f32))

    h_l = [_mip_h(intr.height), _mip_h(-(-intr.height // 2)), _mip_h(-(-intr.height // 4))]
    w_l = [_mip_w(intr.width), _mip_w(-(-intr.width // 2)), _mip_w(-(-intr.width // 4))]
    lvl_i = level.to(torch.int64)
    hi = host_tensor([[h - WIN_V for h in h_l] + [0], [w - WIN_U for w in w_l] + [0]],
                     torch.int32, dev)
    v_hi, u_hi = hi[0][lvl_i], hi[1][lvl_i]
    v0 = torch.minimum(torch.clamp(((cvmin / scale).to(torch.int32) - 1) & ~7, min=0), v_hi)
    u0 = torch.minimum(torch.clamp(((cumin / scale).to(torch.int32) - 1) & ~63, min=0), u_hi)
    v0 = torch.where(level == 3, 0, v0)
    u0 = torch.where(level == 3, 0, u0)

    desc = torch.stack(
        [ci, cj, ck, cls, level, v0.to(torch.int32), u0.to(torch.int32), torch.zeros_like(ci)],
        dim=1,
    )
    order = torch.sort(skip.to(torch.int32), stable=True).indices
    count = (~skip).sum().to(torch.int32).reshape(1)
    wl = WorkList(desc=desc[order].contiguous(), count=count)
    return (wl, free_wl) if free_split else wl


def _free_superblocks(free, skip, neg_flags, nbx_x, nbx_y, nzc):
    """(FreeWorkList, (n,) bool member-chunk mask). A superblock
    qualifies when it lists at least one chunk and every listed chunk in
    it is FREE with no negative flag; those chunks are its members."""
    n = free.shape[0]
    dev = free.device
    neg = torch.zeros_like(free) if neg_flags is None else neg_flags
    free_ok = free & ~skip & ~neg
    blocker = ~skip & ~free_ok  # listed chunks the free carve cannot take

    def g(a):  # (n,) -> (nsx, 4, nsy, 4, nzc), chunk raster order
        return a.reshape(nbx_x // 4, 4, nbx_y // 4, 4, nzc)

    sb_ok = g(free_ok).any(dim=3).any(dim=1) & ~g(blocker).any(dim=3).any(dim=1)
    in_free = g(free_ok) & sb_ok[:, None, :, None, :]
    bitmap = torch.zeros(sb_ok.shape, dtype=torch.int32, device=dev)
    for qi in range(4):
        for qj in range(4):
            bitmap = bitmap | (in_free[:, qi, :, qj, :].to(torch.int32) << (qi * 4 + qj))
    n_sb = bitmap.numel()
    nsy = nbx_y // 4
    ids = torch.arange(n_sb, dtype=torch.int32, device=dev)
    coords = torch.stack([ids // (nsy * nzc), (ids // nzc) % nsy, ids % nzc])
    order = torch.sort((~sb_ok.reshape(n_sb)).to(torch.int32), stable=True).indices
    s_bitmap = bitmap.reshape(n_sb)[order]
    s_coords = coords[:, order]
    count = sb_ok.sum().to(torch.int32)
    # padding repeats the last listed entry; nothing listed -> all zeros.
    # A 1-element index keeps the gather on the device (indexing with the
    # 0-d tensor would read it on the host).
    last = torch.clamp(count - 1, min=0).long().reshape(1)
    real = ids < count
    any_real = count > 0
    fb = torch.where(real, s_bitmap, s_bitmap.index_select(0, last))
    fb = torch.where(any_real, fb, 0)
    fc = torch.where(real[None], s_coords, s_coords.index_select(1, last))
    fc = torch.where(any_real, fc, 0)
    fwl = FreeWorkList(
        bitmap=fb.contiguous(),
        count=torch.clamp(count, min=1).reshape(1),
        bi=fc[0].contiguous(),
        bj=fc[1].contiguous(),
        bk=fc[2].contiguous(),
    )
    return fwl, in_free.reshape(n)


N_PARAMS = 27  # _stream_params' slots K9 reads: the pose to the slab's first X block


@functools.lru_cache(maxsize=None)
def _scratch_bytes(h: int, w: int, n: int, n_sb: int) -> int:
    out = (ctypes.c_int * 1)()
    cuda_lib.check(cuda_lib.load().hs_chunk_select_scratch(h, w, n, n_sb, out),
                   "hs_chunk_select_scratch")
    return out[0]


def launch_chunk_select(depth, planes, params, intr: Intrinsics, resolution, free_split: bool):
    """K9: ``build_worklist``'s lists of one integrate on the card, from
    ``depth`` (h, w), the volume's (or X-slab's) ``planes`` (their field 11
    gives ``sat_quarters`` and ``neg_flags``) and ``params``
    (``ops/tsdf_stream._stream_params``: pose, intrinsics, trunc, voxel
    size, origin, image size, the slab's first X block). Returns
    ``(WorkList, FreeWorkList or None)``: the free list where
    ``free_split`` and the x and y chunk counts are divisible by 4. Raises
    on a shape it does not take, before any launch."""
    dims = (resolution,) * 3 if isinstance(resolution, int) else tuple(int(d) for d in resolution)
    nbx, nby, nzc = dims[0] // 8, dims[1] // 8, dims[2] // 128
    n = nbx * nby * nzc
    if (n < 1 or depth.dim() != 2 or depth.shape[0] < 8 or depth.shape[1] < 8
            or tuple(planes.shape) != (nbx, nby, nzc, N_FIELDS, NSUB_C)
            or params.dim() != 1 or params.numel() < N_PARAMS):
        raise ValueError(
            f"chunk_select: bad volume {dims}, depth {tuple(depth.shape)}, planes "
            f"{tuple(planes.shape)} or params {tuple(params.shape)} shape")
    cuda_lib.require_cuda("chunk_select", depth, planes, params)
    split = free_split and nbx % 4 == 0 and nby % 4 == 0
    n_sb = n // 16 if split else 0
    h, w = depth.shape
    dev = depth.device
    v_hi = [_mip_h(m) - WIN_V for m in (intr.height, -(-intr.height // 2), -(-intr.height // 4))]
    u_hi = [_mip_w(m) - WIN_U for m in (intr.width, -(-intr.width // 2), -(-intr.width // 4))]
    scratch = torch.empty(_scratch_bytes(h, w, n, n_sb), dtype=torch.uint8, device=dev)
    desc = torch.empty((n, 8), dtype=torch.int32, device=dev)
    counts = torch.empty(2, dtype=torch.int32, device=dev)
    fl = torch.empty((4, n_sb), dtype=torch.int32, device=dev) if split else None
    cuda_lib.launch(
        "hs_chunk_select", dev,
        depth.data_ptr(), h, w, planes.data_ptr(), params.data_ptr(), nbx, nby, nzc, int(split),
        *v_hi, *u_hi, scratch.data_ptr(), desc.data_ptr(), counts.data_ptr(),
        fl.data_ptr() if split else None,
    )
    cuda_lib.launch_counts["chunk_select"] += 1
    wl = WorkList(desc=desc, count=counts[:1])
    if not split:
        return wl, None
    return wl, FreeWorkList(bitmap=fl[0], count=counts[1:], bi=fl[1], bj=fl[2], bk=fl[3])


def _mip_h(h: int) -> int:
    """Padded mip height (ops/tsdf_stream.build_depth_mips): +1 replicated
    border row, 8-aligned, at least one window."""
    return max(-(-(h + 1) // 8) * 8, WIN_V)


def _mip_w(w: int) -> int:
    return max(-(-(w + 1) // 128) * 128, WIN_U)


def decode_worklist(wl: WorkList):
    """Numpy (ci, cj, ck, cls, level, v0, u0) rows of the listed chunks."""
    count = int(wl.count[0])
    rows = np.asarray(wl.desc[:count, :7].cpu())
    return [tuple(int(x) for x in r) for r in rows]


def decode_free_worklist(fwl: FreeWorkList):
    """(bitmap, bi, bj, bk) tuples of the listed superblocks, and the
    (ci, cj, ck) member chunks they carve, in list order."""
    count = int(fwl.count[0])
    cols = [np.asarray(a[:count].cpu()) for a in (fwl.bitmap, fwl.bi, fwl.bj, fwl.bk)]
    entries = [tuple(int(c[s]) for c in cols) for s in range(count)]
    members = [
        (bi * 4 + b // 4, bj * 4 + b % 4, bk)
        for bm, bi, bj, bk in entries
        for b in range(16)
        if (bm >> b) & 1
    ]
    return entries, members
