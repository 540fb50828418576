"""Synthetic depth streams of the furnished box room (box world only).

Exact depth frames of an axis-aligned cuboid room furnished with
axis-aligned boxes, rendered by analytic ray intersection, with exact
ground-truth poses. The curved world (spheres, cylinders, rotated boxes)
is not ported yet.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from housescan_tpu_torch.geometry.transform import mm
from housescan_tpu_torch.kinfu.camera import Intrinsics, pixel_rays


def render_box_interior_depth(
    intr: Intrinsics,
    pose: torch.Tensor,
    half_dims: torch.Tensor,
    boxes: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """(H, W) projective depth of the inside of an axis-aligned box room
    centered at the world origin, with optional (B, 2, 3) solid boxes."""
    rays_cam = pixel_rays(intr, device=pose.device)
    rot = pose[:3, :3]
    origin = pose[3, :3]
    dirs = mm(rays_cam, rot)
    eps = 1e-12
    safe_dirs = torch.where(dirs.abs() < eps, torch.full_like(dirs, eps), dirs)
    t_exit_axis = (torch.sign(safe_dirs) * half_dims - origin) / safe_dirs
    t_hit = t_exit_axis.min(dim=-1).values

    if boxes is not None:
        for i in range(boxes.shape[0]):
            t1 = (boxes[i, 0] - origin) / safe_dirs
            t2 = (boxes[i, 1] - origin) / safe_dirs
            t_near = torch.minimum(t1, t2).max(dim=-1).values
            t_far = torch.maximum(t1, t2).min(dim=-1).values
            hit = (t_near <= t_far) & (t_near > 0)
            t_hit = torch.where(hit & (t_near < t_hit), t_near, t_hit)

    depth = torch.where(t_hit > 0, t_hit, torch.zeros_like(t_hit))
    return depth.to(torch.float32)


def orbit_poses(
    n_frames: int,
    radius: float = 0.4,
    height: float = 0.0,
    yaw_range: float = 2 * math.pi,
    pitch: float = 0.0,
) -> np.ndarray:
    """(N, 4, 4) camera-to-world poses orbiting inside the room, yawing to
    sweep the walls. ``pitch`` > 0 tilts the camera toward world -y (the
    ceiling side of ``furnished_room``)."""
    poses = []
    for k in range(n_frames):
        yaw = yaw_range * k / max(n_frames, 1)
        forward = np.array([math.sin(yaw), 0.0, math.cos(yaw)])
        up = np.array([0.0, -1.0, 0.0])
        right = np.cross(up, forward)
        right /= np.linalg.norm(right)
        down = np.cross(forward, right)
        if pitch:
            c, s = math.cos(pitch), math.sin(pitch)
            forward, down = forward * c + down * s, down * c - forward * s
        rot = np.stack([right, down, forward])
        pos = np.array([radius * math.sin(yaw), height, radius * math.cos(yaw)])
        pose = np.eye(4, dtype=np.float32)
        pose[:3, :3] = rot.astype(np.float32)
        pose[3, :3] = pos.astype(np.float32)
        poses.append(pose)
    return np.stack(poses)


def furnished_room(scale: float = 1.0):
    """The standard furnished test room: (half_dims, boxes) as numpy.

    Enough box furniture that every viewpoint constrains all 6 DOF (ICP
    on bare flat walls is rank-deficient)."""
    half = np.array([1.3, 1.1, 1.3], np.float32) * scale
    boxes = np.array(
        [
            [[-0.95, 0.40, -0.95], [-0.35, 1.10, -0.35]],
            [[0.30, 0.50, 0.40], [0.90, 1.10, 1.00]],
            [[-0.20, -1.10, 0.60], [0.40, -0.50, 1.20]],
            [[0.60, 0.70, -1.00], [1.20, 1.10, -0.40]],
            [[-1.25, -0.20, 0.20], [-0.85, 0.30, 0.80]],
            [[0.85, -0.40, -0.60], [1.25, 0.20, 0.00]],
            [[-0.50, 0.85, 0.90], [0.20, 1.10, 1.25]],
            [[-0.15, -0.15, -1.25], [0.45, 0.45, -0.85]],
        ],
        np.float32,
    ) * scale
    return half, boxes


def render_depth_stream(
    intr: Intrinsics,
    poses: np.ndarray,
    half_dims,
    boxes: Optional[np.ndarray] = None,
    device=None,
) -> torch.Tensor:
    """(N, H, W) float32 depth stream on ``device``."""
    half = torch.as_tensor(np.asarray(half_dims), dtype=torch.float32, device=device)
    boxes_t = (
        None
        if boxes is None
        else torch.as_tensor(np.asarray(boxes), dtype=torch.float32, device=device)
    )
    frames = [
        render_box_interior_depth(
            intr, torch.as_tensor(p, dtype=torch.float32, device=device), half, boxes_t
        )
        for p in poses
    ]
    return torch.stack(frames)
