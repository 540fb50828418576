"""TSDF volume: int16-in-int32 packed storage.

Volume layout: ``data[x, y, z]`` with z fastest; the world position of
voxel (i, j, k) is ``origin + (ijk + 0.5) * voxel_size``. TSDF is stored
normalized to [-1, 1] (units of the truncation distance), positive in
free space.

Packed layout, bit-identical to the reference: the tsdf quantized to
[-32767, 32767] in the HIGH half of an int32 and the integer weight in
the LOW half. ``torch.round`` rounds half to even, as ``jnp.round`` does.
Only this production layout is ported; the f32/bf16 (2, X, Y, Z) layouts
are not.

``extract_surface_points`` dumps the zero-crossing voxels as a point
cloud, on the volume's device.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

PACKED_SCALE = 32767.0


def pack_tw(t: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    ti = torch.round(torch.clamp(t, -1.0, 1.0) * PACKED_SCALE).to(torch.int32)
    return (ti << 16) | w.to(torch.int32)


def unpack_t(data: torch.Tensor) -> torch.Tensor:
    # arithmetic shift keeps the sign; the low (weight) bits drop out
    return (data >> 16).to(torch.float32) * (1.0 / PACKED_SCALE)


def unpack_w(data: torch.Tensor) -> torch.Tensor:
    return (data & 0xFFFF).to(torch.float32)


class TsdfVolume(NamedTuple):
    """Packed (X, Y, Z) int32 grid plus geometry as 0-d/1-d float32
    tensors on the grid's device."""

    data: torch.Tensor  # (X, Y, Z) int32: tsdf << 16 | weight
    origin: torch.Tensor  # (3,) world position of the volume min corner
    voxel_size: torch.Tensor  # () meters per voxel
    trunc: torch.Tensor  # () truncation distance in meters

    @property
    def dims(self):
        return tuple(self.data.shape)


def tsdf_new(
    resolution: int = 512,
    size_m: float = 3.0,
    trunc: float = 0.03,
    origin: Optional[torch.Tensor] = None,
    dtype=torch.int32,
    device=None,
) -> TsdfVolume:
    """Fresh volume (tsdf = +1 far free space, weight 0). The default
    origin centers the cube on the world origin."""
    if dtype != torch.int32:
        raise NotImplementedError("only the packed int32 volume is ported")
    if origin is None:
        origin = torch.full((3,), -size_m / 2.0, dtype=torch.float32)
    data = torch.full(
        (resolution,) * 3, 32767 << 16, dtype=torch.int32, device=device
    )
    return TsdfVolume(
        data=data,
        origin=torch.as_tensor(origin, dtype=torch.float32).to(device),
        voxel_size=torch.tensor(size_m / resolution, dtype=torch.float32, device=device),
        trunc=torch.tensor(trunc, dtype=torch.float32, device=device),
    )


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
    t = unpack_t(vol.data)
    w = unpack_w(vol.data)
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
