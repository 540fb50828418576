"""TSDF ray marcher: the model maps of the XLA path.

A port of ``housescan_tpu/kinfu/raycast.py``, the step's raycast for a
volume the plane raycast (K6) does not take: one that does not tile into
128-voxel chunks, or any volume when ``use_pallas=False``. Every pixel ray
marches in lockstep for a fixed ``max_steps`` of ~0.75 trunc with
nearest-voxel samples (a per-pixel done mask, no host-side early exit, so
the host never waits on the card), then a 3-round bracketed secant on
trilinear samples refines the crossing, a strict-support gate drops
partially observed neighbourhoods, and normals come from the vertex map.

Plain tensor code: the reference computes it in XLA, outside any Pallas
kernel. On the card each marching step is a few dozen elementwise
launches over the image, so the 256 steps dominate the fusion step's
launch count and its host time.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from housescan_tpu_torch.geometry.transform import mm
from housescan_tpu_torch.kinfu.camera import Intrinsics, pixel_rays
from housescan_tpu_torch.kinfu.preprocess import vertex_normals
from housescan_tpu_torch.kinfu.tsdf import TsdfVolume, _gather_tw, sample_trilinear
from housescan_tpu_torch.ops.cuda_lib import host_tensor


class RaycastResult(NamedTuple):
    vertices: torch.Tensor  # (H, W, 3) world-frame surface points
    normals: torch.Tensor  # (H, W, 3) unit normals (into free space)
    valid: torch.Tensor  # (H, W) bool
    depth: torch.Tensor  # (H, W) projective depth of the hit (0 invalid)


def _sample_nearest(vol: TsdfVolume, pts_world: torch.Tensor, dims: torch.Tensor) -> torch.Tensor:
    """Nearest-voxel tsdf, +1 outside the volume (``dims`` the (3,)
    int64 voxel counts on the volume's device). One gather a step: an
    unobserved voxel holds +1, so a non-positive sample is observed."""
    _, dy, dz = vol.dims
    g = (pts_world - vol.origin) / vol.voxel_size
    # clamped to [-1, dims] before the cast: the bounds test reads the same
    i = torch.minimum(torch.clamp(torch.floor(g), min=-1.0), dims.to(g.dtype)).to(torch.int64)
    inb = ((i >= 0) & (i < dims)).all(dim=-1)
    ic = torch.minimum(torch.clamp(i, min=0), dims - 1)
    t, _ = _gather_tw(vol, ic[..., 0] * (dy * dz) + ic[..., 1] * dz + ic[..., 2])
    return torch.where(inb, t, 1.0)


@torch.no_grad()
def raycast(
    vol: TsdfVolume,
    pose: torch.Tensor,
    intr: Intrinsics,
    z_min: float = 0.3,
    step_scale: float = 0.75,
    max_steps: int = 256,
) -> RaycastResult:
    """March every pixel ray of camera ``pose`` (4x4 row-vector
    camera-to-world) through the volume to its first zero crossing."""
    dev = vol.data.device
    rays_cam = pixel_rays(intr, torch.float32, device=dev)
    rot = pose[:3, :3]
    origin = pose[3, :3]
    dirs = mm(rays_cam, rot)  # world directions, scaled so that z_cam(t) = t
    inv_scale = 1.0 / torch.linalg.norm(dirs, dim=-1)  # meters of t per unit ray

    # ray / volume box intersection -> per-pixel [t_near, t_far]
    vmin = vol.origin
    dims = host_tensor(vol.dims, torch.int64, dev)
    vmax = vol.origin + dims.to(torch.float32) * vol.voxel_size
    eps = 1e-12
    safe = torch.where(dirs.abs() < eps, eps, dirs)
    t1 = (vmin - origin) / safe
    t2 = (vmax - origin) / safe
    t_near = torch.clamp(torch.minimum(t1, t2).amax(dim=-1), min=z_min)
    t_far = torch.maximum(t1, t2).amin(dim=-1)

    step = vol.trunc * step_scale * inv_scale  # in t units (projective depth)

    t = t_near
    prev = torch.full_like(t_near, float("inf"))  # inf = no valid sample yet
    t_hit = torch.zeros_like(t_near)
    hit = torch.zeros(t_near.shape, dtype=torch.bool, device=dev)
    for _ in range(max_steps):
        val = _sample_nearest(vol, origin + t[..., None] * dirs, dims)
        # previous sample in free space (0 < prev <= 1), current strictly
        # behind the surface (unobserved voxels are +1, never a crossing)
        crossing = (prev > 0) & (prev <= 1.0) & (val < 0) & ~hit
        frac = torch.where((prev - val).abs() > 1e-12, prev / (prev - val), 0.5)
        t_cross = (t - step) + frac * step
        t_hit = torch.where(crossing, t_cross, t_hit)
        hit = hit | crossing
        prev = torch.where(hit, prev, val)
        t = torch.where(~hit & (t < t_far), t + step, t)

    # bracketed secant on trilinear samples: the nearest-sample crossing
    # brackets [t_hit - step, t_hit + step]; each round keeps the sign
    # change inside the bracket
    def tri(tq):
        return sample_trilinear(vol, origin + tq[..., None] * dirs)

    inf = float("inf")
    tl = t_hit - step
    th = t_hit + step
    fl, _ = tri(tl)
    fh, _ = tri(th)
    for _ in range(3):
        denom = fh - fl
        tm = tl - fl * (th - tl) / torch.where(denom.abs() > 1e-12, denom, inf)
        tm = torch.minimum(torch.maximum(tm, tl), th)
        fm, _ = tri(tm)
        take_low = fm > 0  # the crossing goes + (free) -> - (inside)
        tl = torch.where(take_low, tm, tl)
        fl = torch.where(take_low, fm, fl)
        th = torch.where(take_low, th, tm)
        fh = torch.where(take_low, fh, fm)
    denom = fh - fl
    t_ref = tl - fl * (th - tl) / torch.where(denom.abs() > 1e-12, denom, inf)
    t_ref = torch.where(hit, torch.minimum(torch.maximum(t_ref, t_hit - step), t_hit + step), t_hit)
    pts = origin + t_ref[..., None] * dirs

    # strict support: a partially unobserved trilinear neighbourhood has a
    # well-placed vertex but a tilted normal
    _, full_support = sample_trilinear(vol, pts, min_support=0.95)
    hit = hit & full_support

    # normals from the vertex map, not the tsdf gradient (which tilts off
    # the true normal on a one-sided truncated projective tsdf)
    hit3 = hit[..., None]
    hit_pts = torch.where(hit3, pts, 0.0)
    v_cam = torch.where(hit3, mm(hit_pts - origin, rot.T), 0.0)
    n_cam = vertex_normals(v_cam)
    normals = mm(n_cam, rot)
    valid = hit & ((n_cam * n_cam).sum(dim=-1) > 0.25)
    vertices = torch.where(valid[..., None], pts, 0.0)
    normals = torch.where(valid[..., None], normals, 0.0)
    depth = torch.where(valid, t_ref, 0.0)
    return RaycastResult(vertices, normals, valid, depth)
