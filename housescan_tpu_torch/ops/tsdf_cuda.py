"""K8: the first-generation dense TSDF integrate with the fused column
plane fit.

Replaces ``housescan_tpu/ops/tsdf_pallas.py:_kernel`` (line 53, called at
:443 by ``tsdf_integrate_with_planes``, :409; ``tsdf_integrate_pallas``,
:393, drops the planes). The work-list integrate (K4) superseded it on the
fusion step; it is reached through ``ops.tsdf_integrate_pallas`` and the
dense path, with ``raycast_planes.raycast_pallas`` after it.

``tsdf_integrate_with_planes(vol, depth, pose, intr)`` fuses one frame
into a cubic volume whose resolution R tiles into (8, 8, 128) chunks
(R % 128 == 0, R <= 1024) and returns ``(vol, planes)``, the planes of
every (8, 8, R) column as an (R/8, R/8, 16, 128) array: sub-block s of
column (i, j) in lane s < R/8, called (i R/8 + j) R/8 + s, zeros after.
The float32 volume is updated IN PLACE; a packed one is decoded, fused
and re-packed, as the reference's ``replace_grids`` does, with the planes
from the unrounded values.

Per chunk, the reference's own rules (not K4's):

  * mips (``build_dense_mips``): point-sampled ``[::2, ::2]`` levels,
    zero-padded (0 = invalid) with one replicated border row and column;
    L3 is the whole padded 64 x 256 image; 8x8 blocks of the full depth
    give the (64, 128) min (valid pixels), max and all-valid maps;
  * classifier: the chunk's exact in-view bbox (plain in_view test). A
    24-row rectangle of the block maps over the footprint gives dmin,
    dmax and all_valid; SKIP if nothing is in view or the chunk lies
    behind (zmin - trunc > dmax), FREE if the bbox fits 120 px,
    zmax + trunc < dmin, dmax > 0 and every footprint pixel is valid
    (depth BIG: the sample is +1), else BAND;
  * BAND: the mip level whose spans fit (22 s rows, 60 s columns), a
    32 x 256 window at v0 & ~7, u0 & ~127 (L3: the whole image); hat
    weights over the window's rows and columns, contracted rows first
    and then columns, always renormalised by the valid-pixel weight; the
    depth counts where the footprint lies inside the window and the
    valid weight exceeds 1e-6 (no 1/256 snap of u, no all-valid
    shortcut);
  * the plane fit runs over the whole column: z-crossings between its
    chunks count, only z = R - 1 is masked.

The reference loops over 4 z-chunks of the column whatever R is (exact at
512^3); the port takes the column's R/128 chunks.

CUDA kernel, ``csrc/tsdf_dense.cu``, ONE launch in place. Bound:
device-memory bytes (every weight read, the tsdf of the voxels observed
before the frame read, the changed words written, the planes and classes
written; the kernel itself reads every voxel once). A persistent grid
(at most the resident blocks an SM times the SMs, ``_card``) walks the
columns (each block claims its next column from a counter, zeroed by
the launch), each block its columns' chunks in
z order through a ring of three chunk buffers in shared memory, staged two
chunks ahead with bulk copies on mbarriers. Per chunk: a conservative
frustum test of its corner voxels (in double, with a margin above the
per-voxel float32 error) makes most SKIP chunks cost no per-voxel pass;
else the classifier above, each voxel projected once and kept in
registers for the read-modify-write; only changed cells are written back
(a SKIP chunk is never written); then the fit of the chunk before it,
with this chunk's first slice as the halo after its integrate, and of
this chunk where it ends the column. A sub-block without an observed
voxel has all-zero moments: its eigen analysis is computed once a block.
The kernel writes every lane of the planes tile (zeros past R/8), so the
wrapper allocates it without a fill. The outputs are bit-identical to
``dense_integrate_plain``.

CUDA C++ rather than Triton: the kernel stages chunks with Hopper's bulk
copies completing on mbarriers, runs a persistent per-block pipeline
over a shared-memory ring, and shares the double-sum plane fit of
``csrc/planes.cuh`` with K4 and K7.
"""

from __future__ import annotations

import torch

from housescan_tpu_torch.kinfu.camera import Intrinsics
from housescan_tpu_torch.kinfu.tsdf import TsdfVolume, pack_tw, read_tw, write_tw
from housescan_tpu_torch.ops import cuda_lib
from housescan_tpu_torch.ops.planes import N_FIELDS, SUB_Z, plane_fields_plain
from housescan_tpu_torch.ops.tsdf_stream import (
    BIG,
    CHUNK_Z,
    PLAIN_BATCH,
    _card,
    _stream_params,
    chunk_camera,
    chunk_cells,
    stream_grid,
)

WIN_V = 32
WIN_U = 256
L3_V = 64
L3_U = 256
L3_BLOCKS_U = 128  # columns of the 8x8-block min / max / valid maps
RECT_V = 24  # rows of the classifier's footprint rectangle
LANES = 128  # lanes of a column's planes tile
CLS_SKIP, CLS_FREE, CLS_BAND = 0, 1, 2
PLAIN_COLUMNS = 64  # columns per batch of the plain fit


def _pad_zero(m: torch.Tensor, rows_mult: int, cols_to: int) -> torch.Tensor:
    """Zero-pad (0 = invalid) to aligned dims, the last real row and
    column replicated once into the padding (``tsdf_pallas._pad_to``)."""
    h, w = m.shape
    hp = max(-(-(h + 1) // rows_mult) * rows_mult, WIN_V)
    wp = max(cols_to, -(-(w + 1) // 128) * 128, WIN_U)
    return _replicate_border(m, hp, wp)


def _replicate_border(m, hp, wp):
    h, w = m.shape
    out = torch.zeros((hp, wp), dtype=torch.float32, device=m.device)
    out[:h, :w] = m
    out[h, :w] = m[h - 1]
    out[:h, w] = m[:, w - 1]
    out[h, w] = m[h - 1, w - 1]
    return out


def build_dense_mips(depth: torch.Tensor):
    """(m0, m1, m2, l3, l3min, l3max, l3valid) of one (H, W) depth frame
    (``tsdf_pallas._build_mips``)."""
    h, w = depth.shape
    d1 = depth[::2, ::2]
    d2 = d1[::2, ::2]
    d3 = d2[::2, ::2]
    if d3.shape[0] >= L3_V or d3.shape[1] >= L3_U or h // 8 > L3_V or w // 8 > L3_BLOCKS_U:
        raise ValueError(f"tsdf_integrate_with_planes: a {h}x{w} frame exceeds the L3 maps")
    m0 = _pad_zero(depth, 8, -(-w // 128) * 128)
    m1 = _pad_zero(d1, 8, -(-d1.shape[1] // 128) * 128)
    m2 = _pad_zero(d2, 8, -(-d2.shape[1] // 128) * 128)
    l3 = _replicate_border(d3, L3_V, L3_U)
    blocks = depth[: h - h % 8, : w - w % 8].reshape(h // 8, 8, w // 8, 8)
    maps = []
    for fill, val in (
        (BIG, torch.where(blocks > 0, blocks, BIG).amin(dim=(1, 3))),
        (0.0, blocks.amax(dim=(1, 3))),
        (0.0, (blocks > 0).to(torch.float32).amin(dim=(1, 3))),
    ):
        m = torch.full((L3_V, L3_BLOCKS_U), fill, dtype=torch.float32, device=depth.device)
        m[: h // 8, : w // 8] = val
        maps.append(m)
    return tuple(m.contiguous() for m in (m0, m1, m2, l3, *maps))


def _dense_chunks(data, c, mips, p):
    """Plain K8 integrate of chunks ``c`` (B, 3) of the float32 volume, in
    place; returns their classes (B,)."""
    f32 = torch.float32
    dev = data.device
    ci, cj, ck = c[:, 0], c[:, 1], c[:, 2]
    b = c.shape[0]
    fx, fy, cx, cy = p[12], p[13], p[14], p[15]
    trunc = p[16]
    max_weight, img_w, img_h = p[21], p[22], p[23]
    xc, yc, zc = chunk_camera(ci, cj, ck, p)
    safe_z = torch.clamp(zc, min=1e-6)
    uf = fx * xc / safe_z + cx
    vf = fy * yc / safe_z + cy
    iv = (zc > 1e-6) & (uf >= 0.0) & (uf <= img_w - 1.0) & (vf >= 0.0) & (vf <= img_h - 1.0)

    def lo(v):
        return torch.where(iv, v, BIG).reshape(b, -1).amin(dim=1)

    def hi(v):
        return torch.where(iv, v, -BIG).reshape(b, -1).amax(dim=1)

    umin, umax, vmin, vmax, zmin, zmax = lo(uf), hi(uf), lo(vf), hi(vf), lo(zc), hi(zc)
    any_view = iv.reshape(b, -1).any(dim=1)

    # the classifier's rectangle of the 8x8-block maps
    m0, m1, m2, l3, l3min, l3max, l3valid = mips
    r0 = torch.clamp((vmin / 8.0).to(torch.int32) - 1, 0, L3_V - RECT_V) & ~7
    rr = torch.arange(RECT_V, device=dev)
    rows = (r0[:, None] + rr).long()  # (B, 24)
    rowf = (rr.to(f32)[None, :] + r0.to(f32)[:, None])[:, :, None]
    colf = torch.arange(L3_BLOCKS_U, dtype=f32, device=dev)[None, None, :]
    shp = (b, 1, 1)

    def px8(v, off):  # the bbox edge in 8x8 blocks, one block of margin
        return (v / 8.0 + off).reshape(shp)

    in_rect = ((colf >= px8(umin, -1.0)) & (colf <= px8(umax, 1.0))
               & (rowf >= px8(vmin, -1.0)) & (rowf <= px8(vmax, 1.0)))
    dmin = torch.where(in_rect, l3min[rows], BIG).amin(dim=(1, 2))
    dmax = torch.where(in_rect, l3max[rows], -BIG).amax(dim=(1, 2))
    all_valid = torch.where(in_rect, l3valid[rows], 1.0).amin(dim=(1, 2)) > 0.5
    bbox_fits = ((umax - umin) <= 120.0) & ((vmax - vmin) <= 120.0)
    behind = bbox_fits & (zmin - trunc > dmax)
    free = any_view & bbox_fits & (zmax + trunc < dmin) & (dmax > 0.0) & all_valid
    band = any_view & ~behind & ~free
    cls = torch.where(free, CLS_FREE, torch.where(band, CLS_BAND, CLS_SKIP))

    # BAND: level and window, then the hat-weight bilinear depth
    span_u, span_v = umax - umin, vmax - vmin

    def fits(lv):
        s = float(1 << lv)
        return (span_v <= 22.0 * s) & (span_u <= 60.0 * s)

    level = torch.where(fits(0), 0, torch.where(fits(1), 1, torch.where(fits(2), 2, 3)))
    v0 = torch.zeros_like(level)
    u0 = torch.zeros_like(level)
    for lv, mip in enumerate((m0, m1, m2)):
        s = float(1 << lv)
        v0_l = torch.clamp(((vmin / s).to(torch.int32) - 1) & ~7, 0, mip.shape[0] - WIN_V)
        u0_l = torch.clamp(((umin / s).to(torch.int32) - 1) & ~127, 0, mip.shape[1] - WIN_U)
        v0 = torch.where(level == lv, v0_l.to(level.dtype), v0)
        u0 = torch.where(level == lv, u0_l.to(level.dtype), u0)
    mip_list = (m0, m1, m2, l3)
    flat = torch.cat([m.reshape(-1) for m in mip_list])
    offs = [0]
    for m in mip_list[:-1]:
        offs.append(offs[-1] + m.numel())
    off = torch.tensor(offs, device=dev)[level].reshape(shp + (1,))
    mw = torch.tensor([m.shape[1] for m in mip_list], device=dev)[level].reshape(shp + (1,))
    nrows = torch.where(level < 3, WIN_V, L3_V).reshape(shp + (1,))
    scale = torch.exp2(level.to(f32)).reshape(shp + (1,))
    v0r, u0r = v0.reshape(shp + (1,)), u0.reshape(shp + (1,))
    uw = uf / scale - u0r.to(f32)
    vw = vf / scale - v0r.to(f32)
    supp = (uw >= 0.0) & (uw <= float(WIN_U - 1)) & (vw >= 0.0) & (vw <= (nrows - 1).to(f32))
    c0f, r0f = torch.floor(uw), torch.floor(vw)
    wc0 = torch.clamp(1.0 - (uw - c0f).abs(), min=0.0)
    wc1 = torch.clamp(1.0 - (uw - (c0f + 1.0)).abs(), min=0.0)
    wr0 = torch.clamp(1.0 - (vw - r0f).abs(), min=0.0)
    wr1 = torch.clamp(1.0 - (vw - (r0f + 1.0)).abs(), min=0.0)
    c0 = torch.clamp(c0f, 0, WIN_U - 1).long()
    r0w = torch.minimum(torch.clamp(r0f, min=0).long(), nrows - 1)
    c1 = torch.clamp(c0 + 1, max=WIN_U - 1)
    r1w = torch.minimum(r0w + 1, nrows - 1)

    def px(r, col):
        return flat[off + (v0r + r) * mw + u0r + col]

    p00, p01, p10, p11 = px(r0w, c0), px(r0w, c1), px(r1w, c0), px(r1w, c1)
    q00, q01, q10, q11 = ((q > 0.0).to(f32) for q in (p00, p01, p10, p11))
    # rows first (window^T @ row weights), then columns
    num = (p00 * wr0 + p10 * wr1) * wc0 + (p01 * wr0 + p11 * wr1) * wc1
    den = (q00 * wr0 + q10 * wr1) * wc0 + (q01 * wr0 + q11 * wr1) * wc1
    is_free = (cls == CLS_FREE).reshape(shp + (1,))
    d = torch.where(is_free, BIG, num / torch.clamp(den, min=1e-12))
    has = is_free | (supp & (den > 1e-6))

    cells = chunk_cells(ci, cj, ck)
    told, wold = read_tw(data, cells)
    sdf = d - zc
    update = (cls != CLS_SKIP).reshape(shp + (1,)) & iv & has & (sdf >= -trunc)
    sample = torch.clamp(sdf / trunc, -1.0, 1.0)
    wadd = update.to(f32)
    wnew = torch.minimum(wold + wadd, max_weight)
    denom = torch.clamp(wold + wadd, min=1.0)
    tnew = (told * wold + sample * wadd) / denom
    write_tw(data, cells, torch.where(update, tnew, told), wnew)
    return cls.to(torch.int32)


def _column_planes(data, ci, cj, p, nbx):
    """Plain column fit of columns (ci, cj) of the float32 volume:
    (B, N_FIELDS, R/8) fields."""
    nz = data.shape[3]
    ar8 = torch.arange(8, device=data.device)
    b = ci.shape[0]
    cells = ((ci[:, None] * 8 + ar8).reshape(b, 8, 1, 1),
             (cj[:, None] * 8 + ar8).reshape(b, 1, 8, 1),
             torch.arange(nz, device=data.device).reshape(1, 1, 1, nz))
    t, w = read_tw(data, cells)
    z_base = torch.zeros(b, dtype=torch.float32, device=data.device)
    return plane_fields_plain(t, w, ci, cj, z_base, (ci * nbx + cj) * (nz // SUB_Z),
                              p[17], p[18], p[19], p[20])


def dense_integrate_plain(data, mips, params):
    """K8's plain version on the float32 (2, R, R, R) ``data``, in place:
    (chunk classes (R/8 R/8 R/128,) int32, planes (R/8, R/8, 16, 128))."""
    _, (nx, ny, nz) = cuda_lib.volume_layout("tsdf_dense", data)
    nbx, nby, nzc = nx // 8, ny // 8, nz // CHUNK_Z
    dev = data.device
    ids = torch.arange(nbx * nby * nzc, device=dev)
    cls = torch.empty(ids.shape[0], dtype=torch.int32, device=dev)
    for s in range(0, ids.shape[0], PLAIN_BATCH):
        c = ids[s : s + PLAIN_BATCH]
        cls[s : s + PLAIN_BATCH] = _dense_chunks(
            data, torch.stack([c // (nby * nzc), (c // nzc) % nby, c % nzc], dim=1), mips, params)
    planes = torch.zeros((nbx * nby, N_FIELDS, LANES), dtype=torch.float32, device=dev)
    cols = torch.arange(nbx * nby, device=dev)
    for s in range(0, cols.shape[0], PLAIN_COLUMNS):
        c = cols[s : s + PLAIN_COLUMNS]
        planes[s : s + PLAIN_COLUMNS, :, : nz // SUB_Z] = _column_planes(data, c // nby, c % nby,
                                                                         params, nbx)
    return cls, planes.reshape(nbx, nby, N_FIELDS, LANES)


def launch_dense_kernel(data, mips, params):
    """The CUDA K8 launch (one, over every column) on the float32
    (2, R, R, R) ``data``, in place: (chunk classes, planes). The kernel
    writes every lane of the planes, so they are allocated without a
    fill."""
    layout, dims = cuda_lib.volume_layout("tsdf_dense", data)
    if layout != cuda_lib.LAYOUT_F32:
        raise ValueError("tsdf_dense: the kernel takes the float32 layout")
    cuda_lib.require_cuda("tsdf_dense", data, params, *mips)
    if params.numel() < 26 or any(m.dim() != 2 for m in mips):
        raise ValueError("tsdf_dense: bad params or mip shapes")
    nx, ny, nz = dims
    if nx % 8 or ny % 8 or nz % CHUNK_Z or nz // SUB_Z > LANES:
        raise ValueError(f"tsdf_dense: a volume of (8, 8, 128) chunks, R <= 1024, got {dims}")
    nbx, nby, nzc = nx // 8, ny // 8, nz // CHUNK_Z
    cls = torch.empty(nbx * nby * nzc, dtype=torch.int32, device=data.device)
    planes = torch.empty((nbx, nby, N_FIELDS, LANES), dtype=torch.float32, device=data.device)
    grid = stream_grid(nbx * nby, *_card("tsdf_dense", "tsdf_dense_kernel", data.device.index))
    next_col = torch.empty(1, dtype=torch.int32, device=data.device)  # zeroed by the launch
    m0, m1, m2, l3, l3min, l3max, l3valid = mips
    cuda_lib.launch(
        "hs_tsdf_dense", data.device,
        data.data_ptr(), nx, ny, nz,
        m0.data_ptr(), m0.shape[0], m0.shape[1],
        m1.data_ptr(), m1.shape[0], m1.shape[1],
        m2.data_ptr(), m2.shape[0], m2.shape[1],
        l3.data_ptr(), l3.shape[0], l3.shape[1],
        l3min.data_ptr(), l3max.data_ptr(), l3valid.data_ptr(),
        params.data_ptr(), cls.data_ptr(), planes.data_ptr(), next_col.data_ptr(), grid,
    )
    cuda_lib.launch_counts["tsdf_dense"] += 1
    return cls, planes


def dense_inputs(vol: TsdfVolume, depth, pose, intr: Intrinsics, max_weight: float = 128.0):
    """(mips, params) of one frame, on the volume's device."""
    dev = vol.data.device
    depth = torch.as_tensor(depth).to(device=dev, dtype=torch.float32)
    pose = torch.as_tensor(pose).to(device=dev, dtype=torch.float32)
    r = vol.dims[0]
    return build_dense_mips(depth), _stream_params(vol, pose, intr, max_weight, r // 8,
                                                   r // CHUNK_Z)


def tsdf_integrate_with_planes(
    vol: TsdfVolume,
    depth: torch.Tensor,
    pose: torch.Tensor,
    intr: Intrinsics,
    max_weight: float = 128.0,
):
    """Fuse one (H, W) depth frame at the camera-to-world ``pose``:
    (vol, planes (R/8, R/8, 16, 128)). K8 on a CUDA volume, its plain
    version on a CPU one."""
    layout, dims = cuda_lib.volume_layout("tsdf_integrate_with_planes", vol.data)
    if layout == cuda_lib.LAYOUT_BF16:
        # the reference asserts the same (ops/tsdf_pallas.py: "pallas path is f32")
        raise ValueError("tsdf_integrate_with_planes: K8 takes the float32 or packed volume, "
                         "not bfloat16")
    r = dims[0]
    if len(set(dims)) != 1 or r % CHUNK_Z or r // SUB_Z > LANES:
        raise ValueError(f"tsdf_integrate_with_planes: a cubic volume tiling into (8, 8, 128) "
                         f"chunks (R % 128 == 0, R <= 1024) required, got {dims}")
    mips, params = dense_inputs(vol, depth, pose, intr, max_weight)
    packed = layout == cuda_lib.LAYOUT_PACKED
    data = torch.stack([vol.tsdf, vol.weight]) if packed else vol.data
    if data.device.type == "cpu":
        cuda_lib.plain_counts["tsdf_dense"] += 1
        _, planes = dense_integrate_plain(data, mips, params)
    else:
        _, planes = launch_dense_kernel(data, mips, params)
    if packed:
        vol.data.copy_(pack_tw(data[0], data[1]))
    return vol, planes


def tsdf_integrate_pallas(
    vol: TsdfVolume,
    depth: torch.Tensor,
    pose: torch.Tensor,
    intr: Intrinsics,
    max_weight: float = 128.0,
) -> TsdfVolume:
    """Integrate only (the planes are dropped); see
    ``tsdf_integrate_with_planes``."""
    return tsdf_integrate_with_planes(vol, depth, pose, intr, max_weight=max_weight)[0]
