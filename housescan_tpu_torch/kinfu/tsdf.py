"""TSDF volume: both storage layouts, the dense integrate, trilinear
samples and surface points.

Volume layout: ``tsdf[x, y, z]`` with z fastest; the world position of
voxel (i, j, k) is ``origin + (ijk + 0.5) * voxel_size``. TSDF is stored
normalized to [-1, 1] (units of the truncation distance), positive in
free space.

``TsdfVolume.data`` holds one of two layouts, as in the reference:

  * packed: one (X, Y, Z) int32 grid, the tsdf quantized to
    [-32767, 32767] in the HIGH half and the integer weight in the LOW
    half, bit-identical to the reference (``torch.round`` rounds half to
    even, as ``jnp.round`` does);
  * float: one (2, X, Y, Z) array, ``data[0]`` the tsdf grid and
    ``data[1]`` the weight grid: float32, the reference's default (its
    scan fuses into it), or bfloat16 (``TsdfConfig.dtype="bfloat16"``),
    half the bytes. Every reader takes a bfloat16 cell as float32 (exact);
    the kernels store float32 math rounded to nearest even, and the dense
    integrate, as the reference's, computes its running mean in bfloat16
    itself.

Both fusion paths take both layouts. ``tsdf`` / ``weight`` / ``dims`` /
``replace_grids`` read and write either layout, and ``read_tw`` /
``write_tw`` a gathered set of cells of it (the plain versions of the
kernels). ``tsdf_integrate`` is the reference's dense gather-side
integrate (every voxel projects into the frame and pulls its depth),
``sample_trilinear`` / ``tsdf_gradient`` feed the TSDF ray marcher
(``kinfu/raycast.py``), and ``extract_surface_points`` dumps the
zero-crossing voxels as a point cloud. All run on the volume's device
and, but for ``extract_surface_points`` (a ``torch.nonzero``), never wait
on it from the host: small constants reach the card from pinned memory.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from housescan_tpu_torch.kinfu.camera import Intrinsics
from housescan_tpu_torch.ops.cuda_lib import host_tensor

PACKED_SCALE = 32767.0
# Voxels the dense integrate updates per pass: each elementwise
# temporary of a pass is this many elements (128 MiB in float32), so the
# peak stays a few GiB at any resolution (480^3 takes 4 passes).
INTEGRATE_SLAB_VOXELS = 1 << 25


def pack_tw(t: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    ti = torch.round(torch.clamp(t, -1.0, 1.0) * PACKED_SCALE).to(torch.int32)
    return (ti << 16) | w.to(torch.int32)


def unpack_t(data: torch.Tensor) -> torch.Tensor:
    # arithmetic shift keeps the sign; the low (weight) bits drop out
    return (data >> 16).to(torch.float32) * (1.0 / PACKED_SCALE)


def unpack_w(data: torch.Tensor) -> torch.Tensor:
    return (data & 0xFFFF).to(torch.float32)


def read_tw(data: torch.Tensor, idx) -> Tuple[torch.Tensor, torch.Tensor]:
    """Float32 (tsdf, weight) of the cells ``idx`` (an index of the
    (X, Y, Z) grid) of a volume's ``data`` in any layout: decoded from
    the packed grid, or read from the two planes (bfloat16 widened)."""
    if data.dim() == 3:
        cell = data[idx]
        return unpack_t(cell), unpack_w(cell)
    return data[0][idx].float(), data[1][idx].float()


def write_tw(data: torch.Tensor, idx, t: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Store float32 (tsdf, weight) into the cells ``idx`` of any layout
    (the packed grid: ``pack_tw``; the planes: in their type, bfloat16
    rounded to nearest even). Returns the tsdf as stored, which is what a
    later read gives (quantized when packed, rounded in bfloat16)."""
    if data.dim() == 3:
        cell = pack_tw(t, w)
        data[idx] = cell
        return unpack_t(cell)
    ts = t.to(data.dtype)
    data[0][idx] = ts
    data[1][idx] = w.to(data.dtype)
    return ts.float()


class TsdfVolume(NamedTuple):
    """The grids plus geometry as 0-d/1-d float32 tensors on the grids'
    device."""

    data: torch.Tensor  # (X, Y, Z) packed int32 or (2, X, Y, Z) float32 / bfloat16
    origin: torch.Tensor  # (3,) world position of the volume min corner
    voxel_size: torch.Tensor  # () meters per voxel
    trunc: torch.Tensor  # () truncation distance in meters

    @property
    def packed_i32(self) -> bool:
        return self.data.dim() == 3

    @property
    def tsdf(self) -> torch.Tensor:
        """(X, Y, Z) tsdf: unpacked float32 (a new tensor) or a view in
        the planes' type."""
        return unpack_t(self.data) if self.packed_i32 else self.data[0]

    @property
    def weight(self) -> torch.Tensor:
        return unpack_w(self.data) if self.packed_i32 else self.data[1]

    @property
    def dims(self):
        return tuple(self.data.shape) if self.packed_i32 else tuple(self.data.shape[1:])

    def replace_grids(self, tsdf=None, weight=None) -> "TsdfVolume":
        """New volume with either grid swapped (re-packs into ``data``)."""
        t = self.tsdf if tsdf is None else tsdf
        w = self.weight if weight is None else weight
        if self.packed_i32:
            return self._replace(data=pack_tw(t, w))
        return self._replace(data=torch.stack([t, w]).to(self.data.dtype))


def make_volume(tsdf, weight, origin, voxel_size, trunc) -> TsdfVolume:
    """A float-layout volume from separate grids."""
    return TsdfVolume(data=torch.stack([tsdf, weight]), origin=origin,
                      voxel_size=voxel_size, trunc=trunc)


def fresh_data(shape, dtype, device) -> torch.Tensor:
    """Unobserved cells (tsdf +1, weight 0) over the (X, Y, Z) ``shape``
    in a layout: packed int32 (X, Y, Z), or float32 or bfloat16
    (2, X, Y, Z)."""
    if dtype not in (torch.int32, torch.float32, torch.bfloat16):
        raise ValueError(f"a {dtype} volume has no layout (int32, float32 or bfloat16)")
    if dtype == torch.int32:
        return torch.full(shape, 32767 << 16, dtype=torch.int32, device=device)
    data = torch.empty((2,) + tuple(shape), dtype=dtype, device=device)
    data[0].fill_(1.0)
    data[1].zero_()
    return data


def tsdf_new(
    resolution: int = 512,
    size_m: float = 3.0,
    trunc: float = 0.03,
    origin: Optional[torch.Tensor] = None,
    dtype=torch.float32,
    *,
    device="cuda",
) -> TsdfVolume:
    """Fresh volume (tsdf = +1 far free space, weight 0) on ``device``:
    the float32 (2, X, Y, Z) layout by default, as the reference's, the
    same in bfloat16 for ``dtype=torch.bfloat16``, or the packed one for
    ``dtype=torch.int32``. The default origin centers the cube on the
    world origin."""
    if origin is None:
        origin = torch.full((3,), -size_m / 2.0, dtype=torch.float32)
    return TsdfVolume(
        data=fresh_data((resolution,) * 3, dtype, device),
        origin=torch.as_tensor(origin, dtype=torch.float32).to(device),
        voxel_size=torch.tensor(size_m / resolution, dtype=torch.float32, device=device),
        trunc=torch.tensor(trunc, dtype=torch.float32, device=device),
    )


def from_config(cfg, origin=None, *, device="cuda") -> TsdfVolume:
    """Volume for a ``config.TsdfConfig``: "packed_i16" is the packed
    layout, "bfloat16" the bfloat16 planes, any other name the float32
    ones (the reference's mapping)."""
    dtype = {"packed_i16": torch.int32, "bfloat16": torch.bfloat16}.get(cfg.dtype, torch.float32)
    return tsdf_new(cfg.resolution, cfg.size_m, cfg.trunc_dist, origin, dtype, device=device)


def _floor_index(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """floor(x) as int64, with x clamped to [lo, hi] first: the float to
    int cast of a far-out-of-range value is implementation-defined, and
    every caller masks the voxels or points outside [lo, hi] anyway."""
    return torch.floor(torch.clamp(x, lo, hi)).to(torch.int64)


def _bilinear_depth(depth: torch.Tensor, uf: torch.Tensor, vf: torch.Tensor,
                    intr: Intrinsics) -> torch.Tensor:
    """Validity-aware bilinear depth lookup: invalid (0) corners drop out
    of the interpolation; across a discontinuity (corner spread > 0.1 m)
    the nearest corner is taken, so fore- and background never blend."""
    u0 = torch.clamp(_floor_index(uf, -1.0, float(intr.width)), 0, intr.width - 2)
    v0 = torch.clamp(_floor_index(vf, -1.0, float(intr.height)), 0, intr.height - 2)
    fu = torch.clamp(uf - u0, 0.0, 1.0)
    fv = torch.clamp(vf - v0, 0.0, 1.0)
    flat = depth.reshape(-1)
    i00 = v0 * intr.width + u0
    d00, d01 = flat[i00], flat[i00 + 1]
    d10, d11 = flat[i00 + intr.width], flat[i00 + intr.width + 1]
    w00 = (1 - fu) * (1 - fv)
    w01 = fu * (1 - fv)
    w10 = (1 - fu) * fv
    w11 = fu * fv

    ws = [torch.where(d > 0, w, 0.0) for d, w in ((d00, w00), (d01, w01), (d10, w10), (d11, w11))]
    total = ws[0] + ws[1] + ws[2] + ws[3]
    blend = (ws[0] * d00 + ws[1] * d01 + ws[2] * d10 + ws[3] * d11) / torch.clamp(total, min=1e-12)

    dmax = torch.maximum(torch.maximum(d00, d01), torch.maximum(d10, d11))
    inf = float("inf")
    valid_min = torch.where(d00 > 0, d00, inf)
    for d in (d01, d10, d11):
        valid_min = torch.minimum(valid_min, torch.where(d > 0, d, inf))
    discontinuous = (dmax - valid_min) > 0.1

    nearest = torch.where(fv < 0.5, torch.where(fu < 0.5, d00, d01),
                          torch.where(fu < 0.5, d10, d11))
    out = torch.where(discontinuous, nearest, blend)
    return torch.where(total > 1e-6, out, 0.0)


@torch.no_grad()
def tsdf_integrate(
    vol: TsdfVolume,
    depth: torch.Tensor,
    pose: torch.Tensor,
    intr: Intrinsics,
    max_weight: float = 128.0,
    depth_interp: str = "bilinear",
    *,
    x_offset: int = 0,
) -> TsdfVolume:
    """Fuse one (H, W) depth frame at the row-vector camera-to-world
    ``pose`` into the volume, IN PLACE (the reference donates the volume)
    and in any layout; returns ``vol``. ``x_offset``: the volume is the
    X-slab from that plane on of a larger volume whose origin is
    ``vol.origin`` (a sharded slab: the voxel centres are then the whole
    volume's floats).

    Every voxel center projects into the frame, reads its depth
    (``depth_interp`` "bilinear", the default, or "nearest") and folds the
    truncated SDF sample into the running weighted mean. The update is per
    voxel, so the volume is swept in x-slabs of at most
    ``INTEGRATE_SLAB_VOXELS`` voxels, bit-identical to one pass."""
    nx, ny, nz = vol.dims
    slab = max(1, INTEGRATE_SLAB_VOXELS // (ny * nz))
    depth = depth.to(device=vol.data.device, dtype=torch.float32)
    pose = pose.to(device=vol.data.device, dtype=torch.float32)
    for x0 in range(0, nx, slab):
        x1 = min(nx, x0 + slab)
        if vol.packed_i32:
            blk = vol.data[x0:x1]
            t_new, w_new = integrate_core(vol, unpack_t(blk), unpack_w(blk), x_offset + x0,
                                          depth, pose, intr, max_weight, depth_interp)
            blk.copy_(pack_tw(t_new, w_new))
        else:
            t_old, w_old = vol.data[0, x0:x1], vol.data[1, x0:x1]
            t_new, w_new = integrate_core(vol, t_old, w_old, x_offset + x0, depth, pose, intr,
                                          max_weight, depth_interp)
            t_old.copy_(t_new)
            w_old.copy_(w_new)
    return vol


def integrate_core(vol: TsdfVolume, t_old, w_old, x0: int, depth, pose, intr: Intrinsics,
                   max_weight: float = 128.0, depth_interp: str = "bilinear"):
    """The integrate's update of the x-slab ``[x0, x0 + len(t_old))``:
    (new tsdf, new weight) from its grids. The reference's
    ``integrate_core`` over the slab's voxels: the geometry in float32,
    the running mean in the grids' type (bfloat16 rounds every operation
    of it there, as the reference's)."""
    sx, ny, nz = t_old.shape
    dev = t_old.device
    rot = pose[:3, :3]
    t = pose[3, :3]
    f32 = torch.float32
    gx = (vol.origin[0] + (torch.arange(x0, x0 + sx, dtype=f32, device=dev) + 0.5)
          * vol.voxel_size)[:, None, None]
    gy = (vol.origin[1] + (torch.arange(ny, dtype=f32, device=dev) + 0.5) * vol.voxel_size)[None, :, None]
    gz = (vol.origin[2] + (torch.arange(nz, dtype=f32, device=dev) + 0.5) * vol.voxel_size)[None, None, :]

    # world -> camera: p_c = (p_w - t) @ R^T (R is row-vector cam-to-world)
    dxw = gx - t[0]
    dyw = gy - t[1]
    dzw = gz - t[2]
    xc = dxw * rot[0, 0] + dyw * rot[0, 1] + dzw * rot[0, 2]
    yc = dxw * rot[1, 0] + dyw * rot[1, 1] + dzw * rot[1, 2]
    zc = dxw * rot[2, 0] + dyw * rot[2, 1] + dzw * rot[2, 2]

    safe_z = torch.clamp(zc, min=1e-6)
    uf = intr.fx * xc / safe_z + intr.cx
    vf = intr.fy * yc / safe_z + intr.cy
    in_view = (zc > 1e-6) & (uf >= 0) & (uf <= intr.width - 1) & (vf >= 0) & (vf <= intr.height - 1)

    if depth_interp == "bilinear":
        d = _bilinear_depth(depth, uf, vf, intr)
    else:
        # round half to even, as jnp.round; clamped before the cast
        u = torch.clamp(torch.round(torch.clamp(uf, -1.0, float(intr.width))).to(torch.int64),
                        0, intr.width - 1)
        v = torch.clamp(torch.round(torch.clamp(vf, -1.0, float(intr.height))).to(torch.int64),
                        0, intr.height - 1)
        d = depth.reshape(-1)[v * intr.width + u]

    sdf = d - zc
    update = in_view & (d > 0) & (sdf >= -vol.trunc)
    tsdf_sample = torch.clamp(sdf / vol.trunc, -1.0, 1.0).to(t_old.dtype)
    w_add = update.to(t_old.dtype)
    w_new = torch.clamp(w_old + w_add, max=max_weight)
    denom = torch.clamp(w_old + w_add, min=1.0)
    tsdf_upd = (t_old * w_old + tsdf_sample * w_add) / denom
    return torch.where(update, tsdf_upd, t_old), w_new


def _gather_tw(vol: TsdfVolume, idx: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Float32 (tsdf, weight) of the voxels at flat indices ``idx``; a
    packed volume unpacks only the gathered cells."""
    if vol.packed_i32:
        cell = vol.data.reshape(-1)[idx]
        return unpack_t(cell), unpack_w(cell)
    return vol.data[0].reshape(-1)[idx].float(), vol.data[1].reshape(-1)[idx].float()


def sample_trilinear(vol: TsdfVolume, points_world: torch.Tensor,
                     min_support: float = 0.25) -> Tuple[torch.Tensor, torch.Tensor]:
    """Trilinear tsdf samples at world points (..., 3), renormalized over
    the OBSERVED corners (weight > 0): unobserved voxels hold the +1
    initialization, which would bias the surface by up to a voxel.
    Returns (values, valid); valid = in bounds and observed support
    weight > ``min_support``."""
    dx, dy, dz = vol.dims
    g = (points_world - vol.origin) / vol.voxel_size - 0.5
    g0 = torch.floor(g)
    frac = g - g0
    dims = host_tensor([dx, dy, dz], torch.int64, g.device)
    # clamped to [-1, dims] before the cast: the bounds test reads the same
    i0 = torch.minimum(torch.clamp(g0, min=-1.0), dims.to(g0.dtype)).to(torch.int64)
    in_bounds = ((i0 >= 0) & (i0 < dims - 1)).all(dim=-1)
    i0c = torch.minimum(torch.clamp(i0, min=0), dims - 2)

    num = torch.zeros(points_world.shape[:-1], dtype=torch.float32, device=g.device)
    den = torch.zeros_like(num)
    base = i0c[..., 0] * (dy * dz) + i0c[..., 1] * dz + i0c[..., 2]
    fx, fy, fz = frac[..., 0], frac[..., 1], frac[..., 2]
    for ox in (0, 1):
        for oy in (0, 1):
            for oz in (0, 1):
                w = ((fx if ox else 1 - fx) * (fy if oy else 1 - fy) * (fz if oz else 1 - fz))
                t, wt = _gather_tw(vol, base + (ox * dy * dz + oy * dz + oz))
                wo = torch.where(wt > 0, w, 0.0)
                num = num + wo * t
                den = den + wo
    value = num / torch.clamp(den, min=1e-12)
    return value, in_bounds & (den > min_support)


def tsdf_gradient(vol: TsdfVolume, points_world: torch.Tensor) -> torch.Tensor:
    """Central-difference tsdf gradient (the surface normal direction,
    into free space) at world points, from 6 trilinear samples."""
    grads = []
    for axis in range(3):
        offset = torch.zeros(3, dtype=torch.float32, device=points_world.device)
        offset[axis] = vol.voxel_size
        plus, _ = sample_trilinear(vol, points_world + offset)
        minus, _ = sample_trilinear(vol, points_world - offset)
        grads.append(plus - minus)
    g = torch.stack(grads, dim=-1)
    norm = torch.linalg.norm(g, dim=-1, keepdim=True)
    return g / torch.clamp(norm, min=1e-12)


def _axis_crossings(t, w, axis, min_weight):
    """Voxels whose tsdf sign differs from the +axis neighbour's, both
    weights >= ``min_weight``. The neighbour of the last slice is the
    slice itself (edge replication), so that slice never crosses."""
    n = t.shape[axis]
    a, b = t.narrow(axis, 0, n - 1), t.narrow(axis, 1, n - 1)
    wa, wb = w.narrow(axis, 0, n - 1), w.narrow(axis, 1, n - 1)
    cross = torch.zeros(t.shape, dtype=torch.bool, device=t.device)
    cross.narrow(axis, 0, n - 1).copy_(
        (torch.sign(a) != torch.sign(b)) & (wa >= min_weight) & (wb >= min_weight)
    )
    return cross


def extract_surface_points(vol: TsdfVolume, max_points: int, min_weight: float = 1.0) -> torch.Tensor:
    """(n, 3) world positions of the first ``max_points`` zero-crossing
    voxels in raster order (``housescan_tpu/kinfu/tsdf.py:
    extract_surface_points`` returns the same points in a fixed-capacity
    buffer with a count).

    A voxel is on the surface when its tsdf changes sign against the +x,
    +y or +z neighbour. Its point is the voxel center moved by the
    linear sub-voxel offset along the first crossing axis, in priority z,
    y, x."""
    nx, ny, nz = vol.dims
    t = vol.tsdf.float()
    w = vol.weight.float()
    cx = _axis_crossings(t, w, 0, min_weight)
    cy = _axis_crossings(t, w, 1, min_weight)
    cz = _axis_crossings(t, w, 2, min_weight)
    picked = torch.nonzero((cx | cy | cz).reshape(-1)).reshape(-1)[:max_points]

    i = picked // (ny * nz)
    j = (picked // nz) % ny
    k = picked % nz
    t_flat = t.reshape(-1)
    t0 = t_flat[picked]

    def alpha(cmask, last, stride, along):
        on = cmask.reshape(-1)[picked]
        t1 = t_flat[torch.where(along < last, picked + stride, picked)]
        a = torch.where((t0 - t1).abs() > 1e-12, t0 / (t0 - t1), 0.5)
        return on, torch.where(on, torch.clamp(a, 0.0, 1.0), 0.0)

    has_z, az = alpha(cz, nz - 1, 1, k)
    has_y, ay = alpha(cy, ny - 1, nz, j)
    _, ax = alpha(cx, nx - 1, ny * nz, i)
    off_z = torch.where(has_z, az, 0.0)
    off_y = torch.where(~has_z & has_y, ay, 0.0)
    off_x = torch.where(~has_z & ~has_y, ax, 0.0)
    f32 = torch.float32
    ijk = torch.stack([i.to(f32) + off_x, j.to(f32) + off_y, k.to(f32) + off_z], -1)
    return (ijk + 0.5) * vol.voxel_size + vol.origin
