"""K6: tile-grouped plane raycast.

Replaces ``housescan_tpu/ops/raycast_tiles.py:_kernel`` (via
``raycast_tiles_maps``). Phase 1 (``build_tile_candidates``, tensor
code) selects the nearest visible valid or occluder sub-block planes,
assigns each to the (8-row band x 128-px tile) ray tiles its bounding
sphere can touch, and prepares per-candidate intersection constants;
phase 2 (the kernel) intersects every candidate of a tile with the
tile's rays: ray-plane t, in-support and front-facing tests, the nearest
hit with ties going to the larger block id, and the nearest occluder
event.

Selection follows the reference's order exactly: the visible set is the
first MAX_VISIBLE of a STABLE ascending sort of the distance keys (the
reference's ``lax.top_k`` breaks ties lower-index-first; ``torch.topk``
promises no tie order), and each tile's candidates come from a stable
sort of the (tile, distance) composite keys, truncated to the per-tile
budget ``_max_ct`` (96, or 384 on images with fewer than 128 tiles).

CUDA kernel ``csrc/raycast_tiles.cu``: four blocks of 128 threads per
(8 x 128) tile, each thread two pixels of one column; a block stages its
tile's candidates in shared memory as 16-byte vectors (fields 0-11 and
the candidate's pixel box, 6 KB at 96) and counts the usable ones while
staging (the rows within a tile's count have ok = 1, the rows past it
are zero), so every thread loops over that count, not over ``max_ct``.
A pixel outside a candidate's box (the image of its support sphere,
widened by a pixel) cannot hit it and skips it; a plane candidate's
division runs only where the ray can hit it (den < 0). Bound: ~40
instructions per usable candidate and pixel tested, which on the card
is instruction issue rather than bytes.
"""

from __future__ import annotations

import torch

from housescan_tpu_torch.kinfu.camera import Intrinsics
from housescan_tpu_torch.kinfu.tsdf import TsdfVolume
from housescan_tpu_torch.ops import cuda_lib
from housescan_tpu_torch.ops.planes import SUB_Z
from housescan_tpu_torch.utils.metrics import GLOBAL_METRICS

# The reference reads these from HOUSESCAN_RC_* environment variables;
# the port keeps their default values as constants.
MAX_CT = 96  # candidates per tile at production image sizes
SMALL_IMAGE_CT = 384  # per-tile budget below 128 tiles
CHUNK = 96  # candidates per merge step of the plain version
N_PREP = 16  # prepared fields (11 used)
BIG = 1.0e9
MAX_PAIRS = 16  # (band, tile) slots per selected sub-block
MAX_VISIBLE = 4096  # visible sub-blocks kept per frame, nearest first
CURV_CLIFF = 0.021  # lambda_min (voxel^2) above which a block occludes
CURV_TOL = 0.25  # curvature-trim rendered-error tolerance (voxels)


def _max_ct(n_tiles: int) -> int:
    return MAX_CT if n_tiles >= 128 else max(SMALL_IMAGE_CT, MAX_CT)


def build_tile_candidates(
    planes: torch.Tensor,
    pose: torch.Tensor,
    intr: Intrinsics,
    vol: TsdfVolume,
    z_min: float = 0.3,
    block_x0: int = 0,
) -> torch.Tensor:
    """Phase 1: (n_tiles, max_ct, N_PREP) prepared candidates: [n xyz,
    d - n.o, centroid - o xyz, support r^2, block id, ok, occluder,
    0...], zero rows past each tile's count.

    ``block_x0``: the first global X block of an X-slab's planes
    (``parallel/sharded.py``); ``vol.origin`` is the whole volume's, so
    the sub-block centres, and the culling from them, are the whole
    volume's floats."""
    nbx_x, nbx_y = planes.shape[0], planes.shape[1]
    nsub = vol.dims[2] // SUB_Z
    nb = nbx_x * nbx_y * nsub
    n_bands = intr.height // 8
    n_ut = -(-intr.width // 128)
    n_tiles = n_bands * n_ut
    max_ct = _max_ct(n_tiles)
    dev = planes.device
    f32 = torch.float32

    def field(k):
        return planes[:, :, :, k, :].reshape(nb)

    valid = (field(4) > 0.5) & (field(12) <= CURV_CLIFF)
    occl = (~valid) & (field(5) >= 3.0)
    usable = valid | occl
    nx_f, ny_f, nz_f = field(0), field(1), field(2)

    ids = torch.arange(nb, device=dev)
    vs = vol.voxel_size
    radius = vs * (float(32 + SUB_Z * SUB_Z // 4) ** 0.5 + 1.0)
    rot = pose[:3, :3]
    t = pose[3, :3]

    def geometry(sel_ids):
        bi = sel_ids // (nbx_y * nsub)
        bj = (sel_ids // nsub) % nbx_y
        bs = sel_ids % nsub
        dx = vol.origin[0] + ((bi + block_x0) * 8 + 4) * vs - t[0]
        dy = vol.origin[1] + (bj * 8 + 4) * vs - t[1]
        dz = vol.origin[2] + (bs * SUB_Z + SUB_Z // 2) * vs - t[2]
        xc = dx * rot[0, 0] + dy * rot[0, 1] + dz * rot[0, 2]
        yc = dx * rot[1, 0] + dy * rot[1, 1] + dz * rot[1, 2]
        z = dx * rot[2, 0] + dy * rot[2, 1] + dz * rot[2, 2]
        return dx, dy, dz, xc, yc, z

    dx, dy, dz, xc, yc, z = geometry(ids)
    in_front = z + radius > z_min
    facing = (nx_f * -dx + ny_f * -dy + nz_f * -dz) > -radius
    safe_z = torch.clamp(z - radius, min=0.05)
    u = intr.fx * xc / torch.clamp(z, min=1e-6) + intr.cx
    v = intr.fy * yc / torch.clamp(z, min=1e-6) + intr.cy
    pr_u = intr.fx * radius / safe_z
    pr_v = intr.fy * radius / safe_z
    u_overlap = (u + pr_u > 0) & (u - pr_u < intr.width)
    v_overlap = (v + pr_v > 0) & (v - pr_v < intr.height)
    keep = usable & in_front & (facing | occl) & u_overlap & v_overlap

    db_all = torch.clamp(z * (255.0 / 20.0), 0.0, 255.0).to(torch.int32)
    sentinel = 1 << 24
    sel_key = torch.where(keep, db_all, sentinel)
    nv = min(MAX_VISIBLE, nb)
    skeys, sel = torch.sort(sel_key, stable=True)
    skeys, sel = skeys[:nv], sel[:nv]
    keep_s = skeys < sentinel
    db = torch.where(keep_s, skeys, 255).to(torch.int64)

    _, _, _, xc_s, yc_s, z_s = geometry(sel)
    safe_z_s = torch.clamp(z_s - radius, min=0.05)
    u_s = intr.fx * xc_s / torch.clamp(z_s, min=1e-6) + intr.cx
    v_s = intr.fy * yc_s / torch.clamp(z_s, min=1e-6) + intr.cy
    pru_s = intr.fx * radius / safe_z_s
    prv_s = intr.fy * radius / safe_z_s
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
    pair_tile = torch.where(
        pair_ok, (b0_s[:, None] + kb) * n_ut + (t0_s[:, None] + kt), n_tiles
    )
    pair_key = (pair_tile * 256 + db[:, None]).reshape(-1)
    pair_idx = torch.arange(nv, device=dev)[:, None].expand(nv, MAX_PAIRS).reshape(-1)
    sorted_keys, order = torch.sort(pair_key, stable=True)
    sorted_idx = pair_idx[order]
    start_all = torch.searchsorted(
        sorted_keys, torch.arange(n_tiles + 1, device=dev, dtype=sorted_keys.dtype) * 256
    )
    start = start_all[:-1]
    counts = start_all[1:] - start_all[:-1]
    slot = start[:, None] + torch.arange(max_ct, device=dev)[None, :]
    slot_c = torch.clamp(slot, 0, sorted_keys.shape[0] - 1)
    slot_ok = torch.arange(max_ct, device=dev)[None, :] < counts[:, None]
    slot_idx = sorted_idx[slot_c.reshape(-1)]

    stacked = torch.stack(
        [nx_f, ny_f, nz_f, field(3), field(8), field(9), field(10),
         field(7), field(6), occl.to(f32), field(12)],
        dim=0,
    )
    sel_f = stacked[:, sel]
    s_nx, s_ny, s_nz = sel_f[0], sel_f[1], sel_f[2]
    f_num = sel_f[3] - (s_nx * t[0] + s_ny * t[1] + s_nz * t[2])
    sag = 3.46 * torch.sqrt(torch.clamp(sel_f[10], min=0.0))
    shrink2 = torch.where(
        sel_f[9] > 0.5, 1.0,
        torch.clamp(CURV_TOL / torch.clamp(sag, min=1e-9), 0.1225, 1.0),
    )
    prep_t = torch.stack(
        [
            s_nx, s_ny, s_nz, f_num,
            sel_f[4] - t[0], sel_f[5] - t[1], sel_f[6] - t[2],
            sel_f[7] * sel_f[7] * shrink2,
            sel_f[8],
            keep_s.to(f32),
            sel_f[9],
        ],
        dim=0,
    )
    cand = prep_t[:, slot_idx].reshape(prep_t.shape[0], n_tiles, max_ct).permute(1, 2, 0)
    cand = torch.nn.functional.pad(cand, (0, N_PREP - prep_t.shape[0]))
    cand = torch.where(slot_ok[..., None], cand, 0.0)
    return cand.contiguous()


def _ray_params(pose, intr: Intrinsics, z_min, n_ut):
    return cuda_lib.f32_vector(
        [pose[:3, :3], pose[3, :3], intr.fx, intr.fy, intr.cx, intr.cy, z_min, n_ut],
        pose.device,
    )


def raycast_tiles_plain(cand, params, height, w_pad):
    """K6's plain version: (9, height, w_pad) raw rows [depth, vertex xyz,
    normal xyz, block id, occluder event t]; candidates merged CHUNK at a
    time with the reference's min-t / max-id-on-tie rule."""
    dev = cand.device
    f32 = torch.float32
    n_tiles, max_ct, _ = cand.shape
    r00, r01, r02, r10, r11, r12, r20, r21, r22 = (params[k] for k in range(9))
    tx, ty, tz = params[9], params[10], params[11]
    fx, fy, cx, cy = params[12], params[13], params[14], params[15]
    z_min = params[16]
    n_ut = w_pad // 128
    g = torch.arange(n_tiles, device=dev)
    rows = torch.arange(8, dtype=f32, device=dev).reshape(1, 1, 8, 1)
    cols = torch.arange(128, dtype=f32, device=dev).reshape(1, 1, 1, 128)
    u_pix = (g % n_ut * 128).to(f32).reshape(-1, 1, 1, 1) + cols
    v_pix = (g // n_ut * 8).to(f32).reshape(-1, 1, 1, 1) + rows
    dcx = (u_pix - cx) / fx
    dcy = (v_pix - cy) / fy
    dwx = dcx * r00 + dcy * r10 + r20  # (n_tiles, 1, 8, 128)
    dwy = dcx * r01 + dcy * r11 + r21
    dwz = dcx * r02 + dcy * r12 + r22

    acc = None
    for k0 in range(0, max_ct, CHUNK):
        c = cand[:, k0 : k0 + CHUNK]

        def col(f):
            return c[:, :, f].reshape(n_tiles, -1, 1, 1)

        nx, ny, nz, fnum = col(0), col(1), col(2), col(3)
        rx, ry, rz, rad2 = col(4), col(5), col(6), col(7)
        bid, ok, occf = col(8), col(9), col(10)
        den = nx * dwx + ny * dwy + nz * dwz
        safe = torch.where(den.abs() > 1e-9, den, -1e-9)
        tq = fnum / safe
        qx = tq * dwx - rx
        qy = tq * dwy - ry
        qz = tq * dwz - rz
        dist2 = qx * qx + qy * qy + qz * qz
        hit = (ok > 0.5) & (occf < 0.5) & (den < 0.0) & (dist2 <= rad2) & (tq > z_min)
        tt = torch.where(hit, tq, BIG)
        best_t = tt.amin(dim=1, keepdim=True)
        d2 = dwx * dwx + dwy * dwy + dwz * dwz
        ts = (rx * dwx + ry * dwy + rz * dwz) / d2
        ox_ = ts * dwx - rx
        oy_ = ts * dwy - ry
        oz_ = ts * dwz - rz
        miss2 = ox_ * ox_ + oy_ * oy_ + oz_ * oz_
        hit_o = (ok > 0.5) & (occf > 0.5) & (miss2 <= rad2) & (ts > z_min)
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
        acc = [
            torch.where(take, best_t, a_t),
            torch.where(take, bid_c, a_bid),
            torch.where(take, nx_c, a_nx),
            torch.where(take, ny_c, a_ny),
            torch.where(take, nz_c, a_nz),
            torch.minimum(o_c, a_o),
        ]
    best_t, bbid, bnx, bny, bnz, best_o = acc
    got = best_t < BIG
    tq1 = torch.where(got, best_t, 0.0)
    out = torch.cat(
        [
            tq1,
            torch.where(got, tx + tq1 * dwx, 0.0),
            torch.where(got, ty + tq1 * dwy, 0.0),
            torch.where(got, tz + tq1 * dwz, 0.0),
            torch.where(got, bnx, 0.0),
            torch.where(got, bny, 0.0),
            torch.where(got, bnz, 0.0),
            torch.where(got, bbid, -1.0),
            best_o,
        ],
        dim=1,
    )  # (n_tiles, 9, 8, 128)
    n_bands = n_tiles // n_ut
    return out.reshape(n_bands, n_ut, 9, 8, 128).permute(2, 0, 3, 1, 4).reshape(9, n_bands * 8, w_pad)


def raycast_tiles_maps(
    planes: torch.Tensor,
    pose: torch.Tensor,
    intr: Intrinsics,
    vol: TsdfVolume,
    z_min: float = 0.3,
    *,
    block_x0: int = 0,
) -> torch.Tensor:
    """K6: raw model maps before seam masking, (9, H, W): rows [depth,
    vertex xyz, normal xyz, block id, occluder event t (BIG = none)].
    ``block_x0``: an X-slab's first global X block (the planes and
    ``vol`` are the slab's, ``vol.origin`` the whole volume's)."""
    if intr.height % 8:
        raise ValueError("raycast_tiles_maps: image height must be a multiple of 8")
    n_ut = -(-intr.width // 128)
    w_pad = n_ut * 128
    with GLOBAL_METRICS.span("raycast.candidates"):
        cand = build_tile_candidates(planes, pose, intr, vol, z_min=z_min, block_x0=block_x0)
    with GLOBAL_METRICS.span("raycast.tiles"):
        params = _ray_params(pose, intr, z_min, n_ut)
        if cand.device.type == "cpu":
            cuda_lib.plain_counts["raycast_tiles"] += 1
            raw = raycast_tiles_plain(cand, params, intr.height, w_pad)
        else:
            raw = launch_raycast_kernel(cand, params, intr.height, w_pad)
        return raw[:, :, : intr.width]


def launch_raycast_kernel(cand, params, height, w_pad):
    """The CUDA K6 launch: (9, height, w_pad)."""
    cuda_lib.require_cuda("raycast_tiles", cand, params)
    n_tiles, max_ct, n_prep = cand.shape
    if n_prep != N_PREP or n_tiles != (height // 8) * (w_pad // 128) or params.numel() < 17:
        raise ValueError(f"raycast_tiles: bad candidate shape {tuple(cand.shape)}")
    out = torch.empty((9, height, w_pad), dtype=torch.float32, device=cand.device)
    cuda_lib.launch(
        "hs_raycast_tiles", cand.device,
        cand.data_ptr(), n_tiles, max_ct, params.data_ptr(), out.data_ptr(),
        height, w_pad,
    )
    cuda_lib.launch_counts["raycast_tiles"] += 1
    return out
