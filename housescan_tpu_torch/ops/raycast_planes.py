"""Plane-raycast front end: model maps from the sub-block surface planes.

Counterpart of ``housescan_tpu/ops/raycast_pallas.py`` (``raycast_planes``,
``finalize_plane_maps`` and ``raycast_pallas``; tensor code, no kernel of
its own): the raw maps of K6 (``ops/raycast_tiles.py``) go through
occluder suppression, the disagreeing-seam mask and the +-EDGE_PX
silhouette-skirt mask. Neighbour reads wrap around the image, as the
reference's roll. ``raycast_pallas`` renders straight from a volume: K7
(``ops/planes_cuda.py``) extracts the planes, then ``raycast_planes``.
"""

from __future__ import annotations

import torch

from housescan_tpu_torch.kinfu import maps as mp
from housescan_tpu_torch.kinfu.camera import Intrinsics
from housescan_tpu_torch.kinfu.tsdf import TsdfVolume
from housescan_tpu_torch.ops.planes_cuda import extract_subblock_planes
from housescan_tpu_torch.ops.raycast_tiles import raycast_tiles_maps
from housescan_tpu_torch.utils.metrics import GLOBAL_METRICS

EDGE_PX = 4
RAW_BID = 7
RAW_OCC = 8


def raycast_planes(
    planes: torch.Tensor,
    pose: torch.Tensor,
    intr: Intrinsics,
    vol: TsdfVolume,
    z_min: float = 0.3,
) -> torch.Tensor:
    """Channel-major (8, H, W) model maps: depth, world vertex xyz, world
    normal xyz, valid."""
    raw = raycast_tiles_maps(planes, pose, intr, vol, z_min=z_min)
    with GLOBAL_METRICS.span("raycast.finalize"):
        return finalize_plane_maps(raw, voxel_size=vol.voxel_size)


def finalize_plane_maps(raw: torch.Tensor, voxel_size=None) -> torch.Tensor:
    """Seam, occluder and skirt masking of raw (9, H, W) plane-hit maps.

    A pixel is dropped when a gate-failed block is its nearest event
    (more than 2 voxels before the plane hit), when a 4-neighbour hit a
    different block whose plane disagrees (normal dot < 0.9986 or a depth
    step >= 8 cm), or when the +-EDGE_PX box max of the depth exceeds its
    own by more than 2 voxels (a plane extending past a silhouette)."""
    depth = raw[mp.MD_DEPTH]
    normals = raw[mp.MD_N]
    bid = raw[RAW_BID]
    valid = depth > 0

    if raw.shape[0] > RAW_OCC and voxel_size is not None:
        valid = valid & (raw[RAW_OCC] > depth - 2.0 * voxel_size)

    same = valid
    for dim, shift in ((1, 1), (1, -1), (2, 1), (2, -1)):
        nb = torch.roll(raw, shift, dims=dim)
        dot = normals[0] * nb[4] + normals[1] * nb[5] + normals[2] * nb[6]
        agree = (dot > 0.9986) & ((depth - nb[mp.MD_DEPTH]).abs() < 0.08)
        same = same & ((nb[RAW_BID] == bid) | agree)
    valid = same

    if voxel_size is not None:
        acc = depth
        dmax = depth
        for s in range(1, EDGE_PX + 1):
            acc = torch.maximum(acc, torch.roll(dmax, s, dims=0))
            acc = torch.maximum(acc, torch.roll(dmax, -s, dims=0))
        dmax = acc
        for s in range(1, EDGE_PX + 1):
            acc = torch.maximum(acc, torch.roll(dmax, s, dims=1))
            acc = torch.maximum(acc, torch.roll(dmax, -s, dims=1))
        valid = valid & (acc - depth <= 2.0 * voxel_size)

    masked = torch.where(valid[None], raw, 0.0)
    return torch.cat([masked[: mp.MD_VALID], valid[None].to(torch.float32)], dim=0)


def raycast_pallas(
    vol: TsdfVolume,
    pose: torch.Tensor,
    intr: Intrinsics,
    z_min: float = 0.3,
) -> torch.Tensor:
    """Model maps (8, H, W) straight from a volume of either layout: the
    sub-block planes of every chunk (K7), then ``raycast_planes`` (K6 and
    the masks). The reference's name, kept so a reader finds it."""
    planes = extract_subblock_planes(vol)
    return raycast_planes(planes, pose, intr, vol, z_min=z_min)
