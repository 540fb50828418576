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
