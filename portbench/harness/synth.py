"""The benchmark's own depth-frame generator: an analytic furnished room.

A copy of the box-room parts of the port's ``kinfu/synthetic.py``
(``render_box_interior_depth`` for axis-aligned boxes, ``orbit_poses``,
``furnished_room``), kept here so that a change to the program cannot
move the yardstick. The noise differs from the program's in one way: it
is drawn on the device from a ``torch.Generator`` seeded with the run's
seed, so a run makes its frames on the card in a few calls.

Frames are what a depth camera delivers: projective depth rounded to
whole millimetres (uint16 on the wire), here held as int16 (every depth
of the room is below 32.767 m, so the bits agree).
"""

from __future__ import annotations

import math

import numpy as np
import torch


def furnished_room():
    """(half_dims (3,), boxes (B, 2, 3)): the room centred on the world
    origin and its axis-aligned furniture (min and max corners)."""
    half = np.array([1.3, 1.1, 1.3], np.float32)
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
    )
    return half, boxes


WORLDS = {"furnished_room": furnished_room}


def _look_rotation(yaw: float, pitch: float) -> np.ndarray:
    """Rows: the camera axes (right, down, forward) in world coordinates
    for a camera yawed in the XZ plane and tilted by ``pitch`` toward
    world -y."""
    forward = np.array([math.sin(yaw), 0.0, math.cos(yaw)])
    up = np.array([0.0, -1.0, 0.0])
    right = np.cross(up, forward)
    right /= np.linalg.norm(right)
    down = np.cross(forward, right)
    if pitch:
        c, s = math.cos(pitch), math.sin(pitch)
        forward, down = forward * c + down * s, down * c - forward * s
    return np.stack([right, down, forward])


def orbit_poses(n_frames: int, radius: float, yaw_range: float, pitch: float) -> np.ndarray:
    """(N, 4, 4) row-vector camera-to-world poses (``p_world = p_cam @ R +
    t``) on a circle of ``radius`` in the XZ plane, yawing by
    ``yaw_range / n_frames`` a frame."""
    poses = []
    for k in range(n_frames):
        yaw = yaw_range * k / max(n_frames, 1)
        pose = np.eye(4, dtype=np.float32)
        pose[:3, :3] = _look_rotation(yaw, pitch).astype(np.float32)
        pose[3, :3] = np.array([radius * math.sin(yaw), 0.0, radius * math.cos(yaw)], np.float32)
        poses.append(pose)
    return np.stack(poses)


def pixel_rays(width: int, height: int, fx: float, fy: float, cx: float, cy: float,
               device) -> torch.Tensor:
    """(H, W, 3) camera-frame rays with z = 1."""
    u = torch.arange(width, dtype=torch.float32, device=device)
    v = torch.arange(height, dtype=torch.float32, device=device)
    x = ((u[None, :] - cx) / fx).expand(height, width)
    y = ((v[:, None] - cy) / fy).expand(height, width)
    return torch.stack([x, y, torch.ones_like(x)], dim=-1)


def render_depth(cam: dict, pose: torch.Tensor, half: torch.Tensor,
                 boxes: torch.Tensor) -> torch.Tensor:
    """(H, W) float32 projective depth of the room's inside seen from
    ``pose``: the nearest of the walls' exit and the boxes' entries."""
    rays = pixel_rays(cam["width"], cam["height"], cam["fx"], cam["fy"], cam["cx"], cam["cy"],
                      pose.device)
    origin = pose[3, :3]
    dirs = rays @ pose[:3, :3]
    eps = 1e-12
    dirs = torch.where(dirs.abs() < eps, torch.full_like(dirs, eps), dirs)
    t_hit = ((torch.sign(dirs) * half - origin) / dirs).min(dim=-1).values
    for i in range(boxes.shape[0]):
        t1 = (boxes[i, 0] - origin) / dirs
        t2 = (boxes[i, 1] - origin) / dirs
        t_near = torch.minimum(t1, t2).max(dim=-1).values
        t_far = torch.maximum(t1, t2).min(dim=-1).values
        hit = (t_near <= t_far) & (t_near > 0) & (t_near < t_hit)
        t_hit = torch.where(hit, t_near, t_hit)
    return torch.where(t_hit > 0, t_hit, torch.zeros_like(t_hit))


def depth_stream_mm(cam: dict, poses: np.ndarray, world: str, noise_at_2m: float,
                    seed: int, device) -> torch.Tensor:
    """(N, H, W) int16 depth in millimetres on ``device``: each frame
    rendered at its pose, with Kinect-like noise (sigma ``noise_at_2m``
    at 2 m, growing with depth squared) drawn from a generator seeded
    with ``seed`` on ``device``, then rounded to whole millimetres."""
    half_np, boxes_np = WORLDS[world]()
    half = torch.as_tensor(half_np, device=device)
    boxes = torch.as_tensor(boxes_np, device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 63))
    pose_t = torch.as_tensor(poses, dtype=torch.float32, device=device)
    depth = torch.stack([render_depth(cam, pose_t[k], half, boxes) for k in range(len(poses))])
    if noise_at_2m > 0:
        n = torch.randn(depth.shape, generator=gen, device=device, dtype=torch.float32)
        h = depth * 0.5
        depth = torch.where(depth > 0, depth + noise_at_2m * n * h * h, depth)
    return torch.round(depth * 1000.0).clamp(0, 32767).to(torch.int16)
