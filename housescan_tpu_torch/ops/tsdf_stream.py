"""K4 and K5: the work-list TSDF integrate with the persistent sub-block
plane refit, and the pure-free carve of the superblock split.

Replaces ``housescan_tpu/ops/tsdf_stream.py:_kernel`` + ``_process_half``
(via ``tsdf_integrate_stream``). For every chunk of the work list
(``ops/chunk_select.py``), by class:

  * FREE: carve toward +1 every in-view voxel;
  * BAND: bilinear depth from the chunk's mip window (u fraction snapped
    to 1/256; the full footprint must lie inside the window; windows with
    invalid pixels renormalise by the valid weight);
  * REFINE: recompute the in-view bbox per voxel, choose the mip level
    and window from it, then as BAND;

then the weight cap, the read-modify-write, and the refit of the chunk's
16 sub-block planes (``ops/planes.py``) when the updated chunk may hold a
zero crossing, with the per-z-quarter free-space saturation flags and the
any-negative flag in planes field 11, columns 0-4. Unlisted chunks keep
their volume data and planes bit-identical. The volume and the planes are
updated IN PLACE (the reference donates them), which saves a full copy of
the volume per frame.

Every volume layout (``kinfu/tsdf.py``), as in the reference: the packed
int32 grid and the (2, X, Y, Z) array in float32 or bfloat16. The math is
float32 on all three (the reference's "all math is f32"); the layout only
decides how a cell is read and stored (a bfloat16 store rounds to nearest
even)
(``tsdf.read_tw`` / ``write_tw``; in CUDA the storage template of
``csrc/common.cuh``). The plane fit reads the tsdf as stored (quantized
when packed, the float itself otherwise); the saturation and negative
flags read the unrounded updated values.

The reference's hi/lo bf16 splits, the column-flat base and the one-hot
window contractions are MXU precision engineering; here the bilinear
lookup reads its 2x2 taps in plain float32.

K5: the pure-free carve (replaces ``housescan_tpu/ops/tsdf_stream.py:
_free_kernel``). With ``free_split=True``, the reference's default and
this port's, the prepass splits off superblocks of 4 x 4 chunks whose
listed chunks are all FREE with no observed negative tsdf
(``chunk_select.FreeWorkList``). Their member chunks get the CLS_FREE
carve verbatim and a planes tile of zeros with only the per-quarter
saturation flags set in field 11: the eligibility rule guarantees the
carve creates no zero crossing, so this is what K4's ``~may_cross``
branch would write. The free carve runs first; K4 then runs on the
shrunken main list. The two lists are disjoint, so the split is
bit-identical to the unsplit integrate.

CUDA kernel of K4, ``csrc/tsdf_stream.cu``: a persistent grid of
``stream_grid(n_desc, resident, n_sms)`` blocks of 512 threads (at most
the blocks an SM holds at once times the SMs) walks the listed chunks,
block b taking rows b, b + grid, ... below the device-side count, so the
host never waits on the list length and no block is spent on an
unlisted chunk. A block stages its chunk in shared memory with Hopper's
asynchronous bulk copies, two chunks deep (the next one arrives while
this one is integrated), updates it in place as it writes the voxels
back, and one warp per sub-block fits the planes from the staged cells.
Bound: device-memory traffic of 64 KB (packed) or 128 KB (float32) per
listed chunk, plus the plane fit's ~10 float ops per voxel.

CUDA kernel of K5, ``csrc/tsdf_free.cu``: a persistent grid of
``stream_grid(16 * n_sb, resident, n_sms)`` blocks of 4 warps walks the
(free-list entry, member slot) items below 16 x the device-side count,
skipping a clear member bit; warp q of a block carves z-quarter q of its
item's chunk with 16-byte vector loads, a pass of 8 before its first
store, stores back only the vectors whose cells changed, and writes its
quarter's share of the planes tile. Bound: the member chunks' bytes,
read once per member (32 KB packed, 64 KB float32), the changed words
written once, plus its 1 KB planes tile; non-member chunks are never
touched (the TPU kernel copies them through).
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from housescan_tpu_torch.kinfu.camera import Intrinsics
from housescan_tpu_torch.kinfu.maps import halve_maps
from housescan_tpu_torch.kinfu.tsdf import TsdfVolume, read_tw, write_tw
from housescan_tpu_torch.ops import cuda_lib
from housescan_tpu_torch.ops.chunk_select import (
    CLS_FREE,
    CLS_REFINE,
    WIN_U,
    WIN_V,
    FreeWorkList,
    build_worklist,
    launch_chunk_select,
)
from housescan_tpu_torch.ops.planes import N_FIELDS, NSUB_C, chunk_plane_fields
from housescan_tpu_torch.utils.metrics import GLOBAL_METRICS

CHUNK_Z = 128
BIG = 1.0e9
# Free-space saturation: once every observed voxel of a chunk z-quarter
# (8, 8, 32) holds t > 0.999 with weight >= SAT_W, the prepass treats the
# quarter as behind whenever it classifies free.
SAT_W = 8.0
N_QUARTERS = 4
FIELD_SAT = 11
PLAIN_BATCH = 512  # chunks per batch of the plain version


def planes_shape(resolution):
    """Persistent planes shape for a cubic resolution or (nx, ny, nz)."""
    dims = (resolution,) * 3 if isinstance(resolution, int) else tuple(int(d) for d in resolution)
    return (dims[0] // 8, dims[1] // 8, dims[2] // CHUNK_Z, N_FIELDS, NSUB_C)


def _pad_to(m: torch.Tensor, rows_mult: int, cols_to: int) -> torch.Tensor:
    """Edge-pad to aligned dims from h+1/w+1, so a bilinear footprint at
    the last row/col reads a replica (``chunk_select._mip_h/_mip_w``)."""
    h, w = m.shape
    hp = max(-(-(h + 1) // rows_mult) * rows_mult, WIN_V)
    wp = max(cols_to, -(-(w + 1) // 128) * 128, WIN_U)
    return F.pad(m[None, None], (0, wp - w, 0, hp - h), mode="replicate")[0, 0]


def build_depth_mips(depth: torch.Tensor):
    """Padded point-sampled mips L0..L2 and the whole-image L3 window
    (0 = invalid; padding replicates the edge). The reference's 64-px
    shifted copies exist for TPU lane alignment and are not needed."""
    if depth.shape[0] % 8 or depth.shape[1] % 8:
        raise ValueError(f"depth dims must be multiples of 8, got {tuple(depth.shape)}")
    d0 = depth
    d1 = halve_maps(d0[None])[0]
    d2 = halve_maps(d1[None])[0]
    d3 = halve_maps(d2[None])[0]
    m0 = _pad_to(d0, 8, -(-d0.shape[1] // 128) * 128)
    m1 = _pad_to(d1, 8, -(-d1.shape[1] // 128) * 128)
    m2 = _pad_to(d2, 8, -(-d2.shape[1] // 128) * 128)
    h3, w3 = d3.shape
    l3_v = max(-(-(h3 + 1) // 8) * 8, 8)
    l3_u = max(-(-(w3 + 1) // 128) * 128, 128)
    l3 = F.pad(d3[None, None], (0, l3_u - w3, 0, l3_v - h3), mode="replicate")[0, 0]
    return tuple(m.contiguous() for m in (m0, m1, m2, l3))


def _stream_params(vol: TsdfVolume, pose, intr: Intrinsics, max_weight, nbx, nzc, bx0=0):
    """K4's, K5's and K9's params: slot 24 the (global) X block count of
    the sub-block ids, 26 the slab's first global X block."""
    return cuda_lib.f32_vector(
        [
            pose[:3, :3], pose[3, :3],
            intr.fx, intr.fy, intr.cx, intr.cy,
            vol.trunc, vol.voxel_size, vol.origin,
            max_weight, intr.width, intr.height,
            nbx, nzc, bx0,
            0.0, 0.0, 0.0, 0.0, 0.0,
        ],
        vol.data.device,
    )


def chunk_cells(ci, cj, ck):
    """(X, Y, Z) index of the (B, 8, 8, 128) cells of chunks (ci, cj, ck)."""
    ar8 = torch.arange(8, device=ci.device)
    ar128 = torch.arange(CHUNK_Z, device=ci.device)
    b = ci.shape[0]
    return (
        (ci[:, None] * 8 + ar8).reshape(b, 8, 1, 1),
        (cj[:, None] * 8 + ar8).reshape(b, 1, 8, 1),
        (ck[:, None] * CHUNK_Z + ar128).reshape(b, 1, 1, CHUNK_Z),
    )


def chunk_camera(ci, cj, ck, p):
    """Camera-space (xc, yc, zc), each (B, 8, 8, 128), of the voxel centres
    of chunks (ci, cj, ck) under the params vector ``p``
    (``_stream_params``), in the kernels' float32 operation order."""
    f32 = torch.float32
    b = ci.shape[0]
    r00, r01, r02, r10, r11, r12, r20, r21, r22 = (p[k] for k in range(9))
    tx, ty, tz = p[9], p[10], p[11]
    vs = p[17]
    ox, oy, oz = p[18], p[19], p[20]
    ixf = torch.arange(8, dtype=f32, device=ci.device)
    zf = torch.arange(CHUNK_Z, dtype=f32, device=ci.device)
    xw = ox + ((ci * 8).to(f32).reshape(b, 1, 1, 1) + ixf.reshape(1, 8, 1, 1) + 0.5) * vs
    yw = oy + ((cj * 8).to(f32).reshape(b, 1, 1, 1) + ixf.reshape(1, 1, 8, 1) + 0.5) * vs
    zw = oz + ((ck * CHUNK_Z).to(f32).reshape(b, 1, 1, 1) + zf.reshape(1, 1, 1, CHUNK_Z) + 0.5) * vs
    dx = xw - tx
    dy = yw - ty
    dz = zw - tz
    return (dx * r00 + dy * r01 + dz * r02, dx * r10 + dy * r11 + dz * r12,
            dx * r20 + dy * r21 + dz * r22)


def _window_depth(mip, nrows, win_u, scale, v0, u0, uf, vf):
    """Bilinear depth of (B, 8, 8, 128) projections from each chunk's
    (nrows, win_u) window at (v0, u0) of ``mip``: (depth, has_depth)."""
    f32 = torch.float32
    shp = (-1, 1, 1, 1)
    u0f = u0.to(f32).reshape(shp)
    v0f = v0.to(f32).reshape(shp)
    uw = uf / scale - u0f
    uw = torch.round(uw * 256.0) * (1.0 / 256.0)
    vw = vf / scale - v0f
    support = (uw >= 0.0) & (uw <= float(win_u - 1)) & (vw >= 0.0) & (vw <= float(nrows - 1))
    c0f = torch.floor(uw)
    r0f = torch.floor(vw)
    wc0 = torch.clamp(1.0 - (uw - c0f).abs(), min=0.0)
    wc1 = torch.clamp(1.0 - (uw - (c0f + 1.0)).abs(), min=0.0)
    wr0 = torch.clamp(1.0 - (vw - r0f).abs(), min=0.0)
    wr1 = torch.clamp(1.0 - (vw - (r0f + 1.0)).abs(), min=0.0)
    c0 = torch.clamp(c0f, 0, win_u - 1).long()
    r0 = torch.clamp(r0f, 0, nrows - 1).long()
    c1 = torch.clamp(c0 + 1, max=win_u - 1)
    r1 = torch.clamp(r0 + 1, max=nrows - 1)
    rv = v0.long().reshape(shp)
    cu = u0.long().reshape(shp)
    win = mip[rv + torch.arange(nrows, device=mip.device).reshape(1, nrows, 1),
              cu + torch.arange(win_u, device=mip.device).reshape(1, 1, win_u)]
    all_valid = win.reshape(win.shape[0], -1).amin(dim=1) > 0.0  # (B,)

    def px(r, c):
        return mip[rv + r, cu + c]

    p00, p01, p10, p11 = px(r0, c0), px(r0, c1), px(r1, c0), px(r1, c1)
    num = (p00 * wc0 + p01 * wc1) * wr0 + (p10 * wc0 + p11 * wc1) * wr1
    q00, q01, q10, q11 = ((p > 0.0).to(f32) for p in (p00, p01, p10, p11))
    den = (q00 * wc0 + q01 * wc1) * wr0 + (q10 * wc0 + q11 * wc1) * wr1
    av = all_valid.reshape(shp)
    depth = torch.where(av, num, num / torch.clamp(den, min=1e-12))
    has = support & (av | (den > 1e-6))
    return depth, has


def _integrate_chunks(data, planes, d, mips, p, nbx, nzc, bx0=0):
    """Plain K4 over the chunks of descriptor rows ``d`` (B, 8): world x
    and the sub-block ids (of ``nbx`` X blocks) from ci + ``bx0``, the
    data and planes at the slab-local ci."""
    f32 = torch.float32
    dev = data.device
    ci, cj, ck, cls, lvl, v0, u0 = (d[:, k] for k in range(7))
    b = d.shape[0]
    cells = chunk_cells(ci, cj, ck)
    told, wold = read_tw(data, cells)
    fx, fy, cx, cy = p[12], p[13], p[14], p[15]
    trunc, vs = p[16], p[17]
    ox, oy, oz = p[18], p[19], p[20]
    max_weight, img_w, img_h = p[21], p[22], p[23]
    xc, yc, zc = chunk_camera(ci + bx0, cj, ck, p)

    # FREE in-view test, multiplied through by zc as in the reference
    fxx = fx * xc
    fyy = fy * yc
    iv_free = (
        (zc > 1e-6)
        & (fxx >= -cx * zc)
        & (fxx <= (img_w - 1.0 - cx) * zc)
        & (fyy >= -cy * zc)
        & (fyy <= (img_h - 1.0 - cy) * zc)
    )
    safe_z = torch.clamp(zc, min=1e-6)
    uf = fx * xc / safe_z + cx
    vf = fy * yc / safe_z + cy
    iv = (zc > 1e-6) & (uf >= 0.0) & (uf <= img_w - 1.0) & (vf >= 0.0) & (vf <= img_h - 1.0)

    # REFINE: per-voxel in-view bbox -> level and window origin
    flat = (b, -1)
    bumin = torch.where(iv, uf, BIG).reshape(flat).amin(1)
    bumax = torch.where(iv, uf, -BIG).reshape(flat).amax(1)
    bvmin = torch.where(iv, vf, BIG).reshape(flat).amin(1)
    bvmax = torch.where(iv, vf, -BIG).reshape(flat).amax(1)
    any_view = iv.reshape(flat).any(1)
    span_u = bumax - bumin
    span_v = bvmax - bvmin

    def fits(l):
        s = float(1 << l)
        return (span_v <= 22.0 * s) & (span_u <= 60.0 * s)

    lvl_r = torch.where(fits(0), 0, torch.where(fits(1), 1, torch.where(fits(2), 2, 3)))
    sc_r = torch.exp2(lvl_r.to(f32))
    m0, m1, m2, l3 = mips
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
        dl, hl = _window_depth(
            mip, nrows, win_u, float(1 << level),
            v0_e[sel] if level < 3 else zero, u0_e[sel] if level < 3 else zero,
            uf[sel], vf[sel],
        )
        depth[sel] = dl
        has[sel] = hl

    free = (cls == CLS_FREE).reshape(b, 1, 1, 1)
    sdf = depth - zc
    update = torch.where(free, iv_free, iv & has & (sdf >= -trunc))
    sample = torch.where(free, 1.0, torch.clamp(sdf / trunc, -1.0, 1.0))
    wadd = update.to(f32)
    wnew = torch.minimum(wold + wadd, max_weight)
    denom = torch.clamp(wold + wadd, min=1.0)
    tnew = (told * wold + sample * wadd) / denom
    tcur = torch.where(update, tnew, told)
    t_stored = write_tw(data, cells, tcur, wnew)

    # flags from the unquantized updated values, as the reference's
    # sign scratch
    obs = wnew > 0.0
    mn_t = torch.where(obs, tcur, 1.0).reshape(flat).amin(1)
    mx_t = torch.where(obs, tcur, -1.0).reshape(flat).amax(1)
    may_cross = (mn_t < 0.0) & (mx_t >= 0.0)
    qshape = (b, 8, 8, N_QUARTERS, CHUNK_Z // N_QUARTERS)
    q_minw = torch.where(obs, wnew, BIG).reshape(qshape).amin(dim=(1, 2, 4))
    q_mint = torch.where(obs, tcur, 1.0).reshape(qshape).amin(dim=(1, 2, 4))
    q_maxw = wnew.reshape(qshape).amax(dim=(1, 2, 4))
    sat = ((q_minw >= SAT_W) & (q_mint > 0.999) & (q_maxw > 0.0)).to(f32)

    fields = chunk_plane_fields(t_stored, wnew, ci + bx0, cj, ck, vs, ox, oy, oz, nbx, nzc)
    fields = torch.where(may_cross.reshape(b, 1, 1), fields, 0.0)
    fields[:, FIELD_SAT, :N_QUARTERS] = sat
    fields[:, FIELD_SAT, N_QUARTERS] = (mn_t < 0.0).to(f32)
    fields[:, FIELD_SAT, N_QUARTERS + 1:] = 0.0
    planes[ci.long(), cj.long(), ck.long()] = fields


def _carve_chunks(data, planes, c, p, bx0=0):
    """Plain K5 over member chunks ``c`` (B, 3) = (ci, cj, ck): the
    CLS_FREE carve and the planes tile of zeros with the saturation
    flags (``_free_kernel``); world x from ci + ``bx0``."""
    f32 = torch.float32
    dev = data.device
    ci, cj, ck = c[:, 0], c[:, 1], c[:, 2]
    b = c.shape[0]
    cells = chunk_cells(ci, cj, ck)
    told, wold = read_tw(data, cells)
    fx, fy, cx, cy = p[12], p[13], p[14], p[15]
    max_weight, img_w, img_h = p[21], p[22], p[23]
    xc, yc, zc = chunk_camera(ci + bx0, cj, ck, p)
    fxx = fx * xc
    fyy = fy * yc
    iv = (
        (zc > 1e-6)
        & (fxx >= -cx * zc)
        & (fxx <= (img_w - 1.0 - cx) * zc)
        & (fyy >= -cy * zc)
        & (fyy <= (img_h - 1.0 - cy) * zc)
    )
    wadd = iv.to(f32)
    wnew = torch.minimum(wold + wadd, max_weight)
    denom = torch.clamp(wold + wadd, min=1.0)
    tnew = (told * wold + wadd) / denom
    tcur = torch.where(iv, tnew, told)
    write_tw(data, cells, tcur, wnew)

    obs = wnew > 0.0
    qshape = (b, 8, 8, N_QUARTERS, CHUNK_Z // N_QUARTERS)
    q_minw = torch.where(obs, wnew, BIG).reshape(qshape).amin(dim=(1, 2, 4))
    q_mint = torch.where(obs, tcur, 1.0).reshape(qshape).amin(dim=(1, 2, 4))
    q_maxw = wnew.reshape(qshape).amax(dim=(1, 2, 4))
    sat = ((q_minw >= SAT_W) & (q_mint > 0.999) & (q_maxw > 0.0)).to(f32)
    tile = torch.zeros((b, N_FIELDS, NSUB_C), dtype=f32, device=dev)
    tile[:, FIELD_SAT, :N_QUARTERS] = sat
    planes[ci, cj, ck] = tile


def free_carve_plain(data, planes, fwl: FreeWorkList, params, bx0=0):
    """K5's plain version: every member chunk of the listed superblocks,
    updated in place (``bx0``: a slab's first global X block)."""
    n = int(fwl.count[0])
    bits = torch.arange(16, device=data.device)
    member = ((fwl.bitmap[:n, None] >> bits) & 1) > 0  # (n, 16)
    ci = fwl.bi[:n, None] * 4 + bits // 4
    cj = fwl.bj[:n, None] * 4 + bits % 4
    ck = fwl.bk[:n, None].expand(n, 16)
    chunks = torch.stack([ci[member], cj[member], ck[member]], dim=1).long()
    for s in range(0, chunks.shape[0], PLAIN_BATCH):
        _carve_chunks(data, planes, chunks[s : s + PLAIN_BATCH], params, bx0)


def integrate_plain(data, planes, desc, count, mips, params, nbx, nzc, bx0=0):
    """K4's plain version: batches of listed chunks, updated in place
    (``nbx``: the X block count of the sub-block ids, the whole volume's;
    ``bx0``: a slab's first global X block)."""
    n = int(count[0])
    rows = desc[:n].long()
    for s in range(0, n, PLAIN_BATCH):
        _integrate_chunks(data, planes, rows[s : s + PLAIN_BATCH], mips, params, nbx, nzc, bx0)


def tsdf_integrate_stream(
    vol: TsdfVolume,
    planes: torch.Tensor,
    depth: torch.Tensor,
    pose: torch.Tensor,
    intr: Intrinsics,
    max_weight: float = 128.0,
    *,
    free_split: bool = True,
    global_blocks=None,
):
    """Integrate ``depth`` at ``pose`` into the volume (any layout) and
    refresh the persistent planes of every listed chunk, both IN PLACE:
    the free carve (K5) over the pure-free superblocks when
    ``free_split``, then K4 over the main list. Returns (vol, planes).

    ``global_blocks`` = (global X block count, the slab's first X block)
    for an X-slab of a sharded volume (``parallel/sharded.py``), whose
    ``vol.origin`` is then the WHOLE volume's origin: world coordinates
    and sub-block ids take the global block, so every float of the slab is
    the one the whole volume computes (a slab-local origin rounds
    differently in float32)."""
    _, dims = cuda_lib.volume_layout("tsdf_integrate_stream", vol.data)
    if any(d % 8 for d in dims) or dims[2] % CHUNK_Z:
        raise ValueError(f"tsdf_integrate_stream: a volume tiling into (8, 8, 128) chunks required, got {dims}")
    nbx, nby, nzc = dims[0] // 8, dims[1] // 8, dims[2] // CHUNK_Z
    id_nbx, bx0 = (nbx, 0) if global_blocks is None else (int(global_blocks[0]), int(global_blocks[1]))
    if tuple(planes.shape) != planes_shape(dims):
        raise ValueError(f"planes shape {tuple(planes.shape)} != {planes_shape(dims)}")
    depth = depth.to(torch.float32)
    cpu = vol.data.device.type == "cpu"
    with GLOBAL_METRICS.span("integrate.prepass"):
        params = _stream_params(vol, pose, intr, max_weight, id_nbx, nzc, bx0)
        if cpu:
            cuda_lib.plain_counts["chunk_select"] += 1
            sat_q = planes[:, :, :, FIELD_SAT, :N_QUARTERS].reshape(-1, N_QUARTERS) > 0.5
            geom = (depth, pose, intr, dims, vol.voxel_size, vol.origin, vol.trunc)
            if free_split:
                neg_c = planes[:, :, :, FIELD_SAT, N_QUARTERS].reshape(-1) > 0.5
                wl, fwl = build_worklist(*geom, sat_quarters=sat_q, block_x0=bx0,
                                         neg_flags=neg_c, free_split=True)
            else:
                wl, fwl = build_worklist(*geom, sat_quarters=sat_q, block_x0=bx0), None
        else:
            wl, fwl = launch_chunk_select(depth, planes, params, intr, dims, free_split)
    GLOBAL_METRICS.count("integrate.listed_chunks", wl.count)
    if fwl is not None:
        GLOBAL_METRICS.count("integrate.free_superblocks", fwl.count)
    with GLOBAL_METRICS.span("integrate.mips"):
        mips = build_depth_mips(depth)
    if fwl is not None:
        with GLOBAL_METRICS.span("integrate.free"):
            if cpu:
                cuda_lib.plain_counts["tsdf_free"] += 1
                free_carve_plain(vol.data, planes, fwl, params, bx0)
            else:
                launch_free_kernel(vol.data, planes, fwl, params)
    with GLOBAL_METRICS.span("integrate.stream"):
        if cpu:
            cuda_lib.plain_counts["tsdf_stream"] += 1
            integrate_plain(vol.data, planes, wl.desc, wl.count, mips, params, id_nbx, nzc, bx0)
        else:
            launch_stream_kernel(vol.data, planes, wl.desc, wl.count, mips, params)
    return vol, planes


def stream_grid(n_items: int, resident: int, n_sms: int) -> int:
    """K4's and K5's persistent grid: a block for every item (K4: a row of
    the list; K5: a member slot of a free-list entry), but no more blocks
    than the card holds at once."""
    return min(n_items, resident * n_sms)


@functools.lru_cache(maxsize=None)
def _card(kernel: str, key: str, device: int):
    """(resident blocks an SM of ``kernel``'s instance ``key`` (its keys in
    ``cuda_lib.OCCUPANCY``), SMs) of CUDA device ``device``."""
    with torch.cuda.device(device):
        return cuda_lib.occupancy(kernel)[key], cuda_lib.device_limits()[0]


def _layout_key(layout: int) -> str:
    """K4's, K5's and K7's occupancy key of a volume layout."""
    return {cuda_lib.LAYOUT_PACKED: "packed", cuda_lib.LAYOUT_F32: "float32",
            cuda_lib.LAYOUT_BF16: "bfloat16"}[layout]


def launch_stream_kernel(data, planes, desc, count, mips, params):
    """The CUDA K4 launch over a work list (in place), on either volume
    layout."""
    layout, dims = cuda_lib.volume_layout("tsdf_stream", data)
    cuda_lib.require_cuda("tsdf_stream", data, dtype=data.dtype)
    cuda_lib.require_cuda("tsdf_stream", desc, count, dtype=torch.int32)
    cuda_lib.require_cuda("tsdf_stream", planes, params, *mips)
    if (tuple(planes.shape) != planes_shape(dims)
            or desc.dim() != 2 or desc.shape[1] != 8 or count.numel() != 1
            or params.numel() < 26 or any(m.dim() != 2 or m.shape[1] % 128 for m in mips)):
        raise ValueError("tsdf_stream: bad volume, planes, work-list, params or mip shapes")
    nx, ny, nz = dims
    m0, m1, m2, l3 = mips
    grid = stream_grid(desc.shape[0], *_card("tsdf_stream", _layout_key(layout), data.device.index))
    if grid < 1 and desc.shape[0]:
        raise ValueError("tsdf_stream: no block of the kernel fits on an SM")
    cuda_lib.launch(
        "hs_tsdf_stream", data.device,
        data.data_ptr(), layout, planes.data_ptr(), desc.data_ptr(), count.data_ptr(),
        grid, nx, ny, nz,
        m0.data_ptr(), m0.shape[0], m0.shape[1],
        m1.data_ptr(), m1.shape[0], m1.shape[1],
        m2.data_ptr(), m2.shape[0], m2.shape[1],
        l3.data_ptr(), l3.shape[0], l3.shape[1],
        params.data_ptr(), SAT_W,
    )
    cuda_lib.launch_counts["tsdf_stream"] += 1


def launch_free_kernel(data, planes, fwl: FreeWorkList, params):
    """The CUDA K5 launch over a free work list (in place), on either
    volume layout."""
    layout, dims = cuda_lib.volume_layout("tsdf_free", data)
    cuda_lib.require_cuda("tsdf_free", data, dtype=data.dtype)
    cuda_lib.require_cuda("tsdf_free", fwl.bitmap, fwl.count, fwl.bi, fwl.bj, fwl.bk,
                          dtype=torch.int32)
    cuda_lib.require_cuda("tsdf_free", planes, params)
    n_sb = fwl.bitmap.shape[0]
    if (tuple(planes.shape) != planes_shape(dims)
            or fwl.count.numel() != 1 or params.numel() < 26
            or any(a.dim() != 1 or a.shape[0] != n_sb for a in (fwl.bi, fwl.bj, fwl.bk))
            or dims[0] % 32 or dims[1] % 32):
        raise ValueError("tsdf_free: bad volume, planes, free work-list or params shapes")
    nx, ny, nz = dims
    grid = stream_grid(16 * n_sb, *_card("tsdf_free", _layout_key(layout), data.device.index))
    if grid < 1 and n_sb:
        raise ValueError("tsdf_free: no block of the kernel fits on an SM")
    cuda_lib.launch(
        "hs_tsdf_free", data.device,
        data.data_ptr(), layout, planes.data_ptr(), fwl.bitmap.data_ptr(), fwl.count.data_ptr(),
        fwl.bi.data_ptr(), fwl.bj.data_ptr(), fwl.bk.data_ptr(), grid, nx, ny, nz,
        params.data_ptr(), SAT_W,
    )
    cuda_lib.launch_counts["tsdf_free"] += 1
