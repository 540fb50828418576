"""K4's work for one frame: the chunks its truncation band reaches.

Every depth sample is walked along its own ray from range - trunc to
range + trunc in steps of at most half a voxel; each point's voxel names
its (8, 8, 128) chunk, and every chunk so reached is read once and
written once: its tsdf and weight (8 bytes a voxel each way on the
float32 volume) and its 16 x 16 float32 tile of sub-block planes
(written), plus the frame itself, read once. Operations: 170 float
operations a voxel of those chunks (about 80 for the projection, the
bilinear depth, the truncated sample and the running mean; about 90 for
the sub-block plane fit's moments over the three crossing families).
"""

from __future__ import annotations

import math

import torch

CHUNK = (8, 8, 128)
OPS_PER_VOXEL = 170
PLANES_TILE_BYTES = 16 * 16 * 4


def band_chunks(depth, pose, cam: dict, resolution: int, size_m: float, trunc: float) -> int:
    """How many chunks of a cubic ``resolution`` volume of side
    ``size_m`` (centred on the world origin) the band of the (H, W)
    metre ``depth`` frame at the row-vector camera-to-world ``pose``
    reaches."""
    dev = depth.device
    h, w = depth.shape
    u = torch.arange(w, dtype=torch.float32, device=dev)
    v = torch.arange(h, dtype=torch.float32, device=dev)
    rx = ((u[None, :] - cam["cx"]) / cam["fx"]).expand(h, w)
    ry = ((v[:, None] - cam["cy"]) / cam["fy"]).expand(h, w)
    valid = depth > 0
    rays = torch.stack([rx[valid], ry[valid], torch.ones_like(rx[valid])], dim=1)
    norm = rays.norm(dim=1)
    unit = rays / norm[:, None]
    rng = depth[valid] * norm
    voxel = size_m / resolution
    n_steps = int(math.ceil(2 * trunc / (0.5 * voxel))) + 1
    offs = torch.linspace(-trunc, trunc, n_steps, device=dev)
    nb = resolution // CHUNK[0]
    nz = resolution // CHUNK[2]
    seen = torch.zeros(nb * nb * nz, dtype=torch.bool, device=dev)
    pose = torch.as_tensor(pose, dtype=torch.float32, device=dev)
    for s in offs:
        cam_pts = unit * (rng + s)[:, None]
        world = cam_pts @ pose[:3, :3] + pose[3, :3]
        idx = torch.floor((world + size_m / 2) / voxel).to(torch.int64)
        inside = ((idx >= 0) & (idx < resolution)).all(dim=1)
        idx = idx[inside]
        ids = (idx[:, 0] // CHUNK[0] * nb + idx[:, 1] // CHUNK[1]) * nz + idx[:, 2] // CHUNK[2]
        seen[ids] = True
    return int(seen.sum())


def frame_work(depth, pose, cam: dict, resolution: int, size_m: float, trunc: float):
    """(bytes, ops) of K4 over one frame on the float32 volume."""
    n = band_chunks(depth, pose, cam, resolution, size_m, trunc)
    voxels = CHUNK[0] * CHUNK[1] * CHUNK[2]
    n_bytes = n * (2 * voxels * 8 + PLANES_TILE_BYTES) + depth.numel() * 4
    return n_bytes, n * voxels * OPS_PER_VOXEL
