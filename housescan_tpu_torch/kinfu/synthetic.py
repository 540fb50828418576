"""Synthetic depth streams: an analytic room scanner.

A port of ``housescan_tpu/kinfu/synthetic.py``. Exact depth frames of a
cuboid room furnished with axis-aligned boxes, spheres, capped cylinders
and yaw-rotated boxes, rendered by analytic ray intersection, with exact
ground-truth poses and an exact ground-truth TSDF. The curved shapes
(``curved_furnished_room``) exist because a piecewise-planar raycast
model represents boxes exactly away from edges: only curvature and
oblique planes expose its bias.

Frames are rendered on ``device`` (default the card). Sensor noise is
drawn on the host from ``np.random.default_rng(seed)``, one
``rng.normal`` per frame in pose order, exactly as the reference draws
it, and applied in float64 before the cast to float32; the same seed
then gives the same frames to within the renderer's rounding.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from housescan_tpu_torch.geometry.transform import mm, on_device
from housescan_tpu_torch.kinfu.camera import Intrinsics, pixel_rays


def _aabb_entry(bmin, bmax, o, d):
    t1 = (bmin - o) / d
    t2 = (bmax - o) / d
    t_near = torch.minimum(t1, t2).max(dim=-1).values
    t_far = torch.maximum(t1, t2).min(dim=-1).values
    return t_near, (t_near <= t_far) & (t_near > 0)


def _nearest(hit, t, t_hit):
    return torch.where(hit & (t < t_hit), t, t_hit)


def render_box_interior_depth(
    intr: Intrinsics,
    pose: torch.Tensor,
    half_dims: torch.Tensor,
    boxes: Optional[torch.Tensor] = None,
    spheres: Optional[torch.Tensor] = None,
    cylinders: Optional[torch.Tensor] = None,
    obbs: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """(H, W) projective depth of the inside of an axis-aligned box room
    centered at the world origin, on ``pose``'s device.

    ``pose`` is the 4x4 row-vector camera-to-world transform. Furniture,
    all solid: ``boxes`` (B, 2, 3) axis-aligned (min, max corner);
    ``spheres`` (S, 4) [cx, cy, cz, r]; ``cylinders`` (C, 5) Y-axis
    capped cylinders [cx, cz, r, y_min, y_max]; ``obbs`` (B, 7) boxes
    [cx, cy, cz, hx, hy, hz, yaw] rotated by ``yaw`` about world Y around
    their center."""
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
            t_near, hit = _aabb_entry(boxes[i, 0], boxes[i, 1], origin, safe_dirs)
            t_hit = _nearest(hit, t_near, t_hit)

    if spheres is not None:
        for i in range(spheres.shape[0]):
            c, r = spheres[i, :3], spheres[i, 3]
            oc = origin - c
            a = (dirs * dirs).sum(dim=-1)
            b = 2.0 * (dirs * oc).sum(dim=-1)
            cc = (oc * oc).sum() - r * r
            disc = b * b - 4.0 * a * cc
            sq = torch.sqrt(torch.clamp(disc, min=0.0))
            t_near = (-b - sq) / (2.0 * a)
            t_hit = _nearest((disc > 0) & (t_near > 0), t_near, t_hit)

    if cylinders is not None:
        for i in range(cylinders.shape[0]):
            cx, cz, r, y0, y1 = (cylinders[i, k] for k in range(5))
            ox = origin[0] - cx
            oz = origin[2] - cz
            dx, dy, dz = dirs[..., 0], dirs[..., 1], dirs[..., 2]
            # side surface: a quadratic in the XZ plane, y clamped
            a = dx * dx + dz * dz
            b = 2.0 * (ox * dx + oz * dz)
            cc = ox * ox + oz * oz - r * r
            disc = b * b - 4.0 * a * cc
            sq = torch.sqrt(torch.clamp(disc, min=0.0))
            a_safe = torch.where(a.abs() < eps, torch.full_like(a, eps), a)
            t_side = (-b - sq) / (2.0 * a_safe)
            y_at = origin[1] + t_side * dy
            hit = (disc > 0) & (t_side > 0) & (y_at >= y0) & (y_at <= y1)
            t_hit = _nearest(hit, t_side, t_hit)
            # caps: the disk the ray meets first is the one facing it
            dy_safe = torch.where(dy.abs() < eps, torch.full_like(dy, eps), dy)
            for y_cap in (y0, y1):
                t_cap = (y_cap - origin[1]) / dy_safe
                px = ox + t_cap * dx
                pz = oz + t_cap * dz
                t_hit = _nearest((t_cap > 0) & (px * px + pz * pz <= r * r), t_cap, t_hit)

    if obbs is not None:
        for i in range(obbs.shape[0]):
            c, h, yaw = obbs[i, :3], obbs[i, 3:6], obbs[i, 6]
            cy, sy = torch.cos(yaw), torch.sin(yaw)
            zero, one = torch.zeros_like(cy), torch.ones_like(cy)
            # world -> box frame rows: v_box = v_world @ R(-yaw)
            rbox = torch.stack([torch.stack([cy, zero, -sy]), torch.stack([zero, one, zero]),
                                torch.stack([sy, zero, cy])])
            o_b = mm(origin - c, rbox.T)
            d_b = mm(dirs, rbox.T)
            d_b = torch.where(d_b.abs() < eps, torch.full_like(d_b, eps), d_b)
            t_near, hit = _aabb_entry(-h, h, o_b, d_b)
            t_hit = _nearest(hit, t_near, t_hit)

    # rays have z_cam = 1, so the depth is t
    depth = torch.where(t_hit > 0, t_hit, torch.zeros_like(t_hit))
    return depth.to(torch.float32)


def _look_rotation(yaw: float, pitch: float, forward=None) -> np.ndarray:
    """Rows: the camera axes (right, down, forward) in world coordinates
    for a camera looking along ``forward`` (default: yaw in the XZ plane),
    tilted by ``pitch`` toward world -y. (The reference skips the tilt at
    pitch 0 in ``orbit_poses`` and applies it in ``spiral_poses``; a tilt
    by 0 leaves every entry as it is.)"""
    if forward is None:
        forward = np.array([math.sin(yaw), 0.0, math.cos(yaw)])
    up = np.array([0.0, -1.0, 0.0])  # world up is -y in the camera convention
    right = np.cross(up, forward)
    right /= np.linalg.norm(right)
    down = np.cross(forward, right)
    if pitch:
        c, s = math.cos(pitch), math.sin(pitch)
        forward, down = forward * c + down * s, down * c - forward * s
    return np.stack([right, down, forward])


def _pose(rot: np.ndarray, pos: np.ndarray) -> np.ndarray:
    pose = np.eye(4, dtype=np.float32)
    pose[:3, :3] = rot.astype(np.float32)
    pose[3, :3] = pos.astype(np.float32)
    return pose


def orbit_poses(
    n_frames: int,
    radius: float = 0.4,
    height: float = 0.0,
    yaw_range: float = 2 * math.pi,
    pitch: float = 0.0,
    look_jitter: float = 0.0,
    seed: int = 0,
) -> np.ndarray:
    """(N, 4, 4) camera-to-world poses orbiting inside the room, yawing to
    sweep the walls. ``pitch`` > 0 tilts the camera toward world -y (the
    ceiling side of ``furnished_room``); ``look_jitter`` perturbs each
    forward direction by normal noise drawn from ``default_rng(seed)``."""
    rng = np.random.default_rng(seed)
    poses = []
    for k in range(n_frames):
        yaw = yaw_range * k / max(n_frames, 1)
        forward = np.array([math.sin(yaw), 0.0, math.cos(yaw)])
        if look_jitter:
            forward = forward + rng.normal(scale=look_jitter, size=3)
            forward /= np.linalg.norm(forward)
        pos = np.array([radius * math.sin(yaw), height, radius * math.cos(yaw)])
        poses.append(_pose(_look_rotation(yaw, pitch, forward), pos))
    return np.stack(poses)


def spiral_poses(
    n_frames: int,
    turns: float = 2.0,
    radius: float = 0.25,
    pitch_max: float = 0.8,
    height_max: float = 0.0,
) -> np.ndarray:
    """(N, 4, 4) trackable full-coverage sweep: continuous yaw over
    ``turns`` revolutions while the pitch swings sinusoidally through
    +-``pitch_max``, so one smooth trajectory sees all six faces with
    small inter-frame motion."""
    poses = []
    for k in range(n_frames):
        p = k / max(n_frames - 1, 1)
        yaw = turns * 2 * math.pi * p
        swing = math.sin(2 * math.pi * p)
        height = -height_max * swing  # look up from low, down from high
        pos = np.array([radius * math.sin(yaw), height, radius * math.cos(yaw)])
        poses.append(_pose(_look_rotation(yaw, pitch_max * swing), pos))
    return np.stack(poses)


def furnished_room(scale: float = 1.0):
    """The standard furnished test room: (half_dims, boxes) as numpy.

    Enough box furniture that every viewpoint constrains all 6 DOF (ICP
    on bare flat walls is rank-deficient)."""
    half = np.array([1.3, 1.1, 1.3], np.float32) * scale
    boxes = np.array(
        [
            [[-0.95, 0.40, -0.95], [-0.35, 1.10, -0.35]],  # crate, floor corner
            [[0.30, 0.50, 0.40], [0.90, 1.10, 1.00]],  # crate, opposite side
            [[-0.20, -1.10, 0.60], [0.40, -0.50, 1.20]],  # cabinet, ceiling side
            [[0.60, 0.70, -1.00], [1.20, 1.10, -0.40]],  # bench
            [[-1.25, -0.20, 0.20], [-0.85, 0.30, 0.80]],  # shelf on -x wall
            [[0.85, -0.40, -0.60], [1.25, 0.20, 0.00]],  # shelf on +x wall
            [[-0.50, 0.85, 0.90], [0.20, 1.10, 1.25]],  # low table at +z
            [[-0.15, -0.15, -1.25], [0.45, 0.45, -0.85]],  # box on -z wall
        ],
        np.float32,
    ) * scale
    return half, boxes


def curved_furnished_room(scale: float = 1.0):
    """The furnished room with curved and oblique furniture:
    (half_dims, boxes, spheres, cylinders, obbs) as numpy.

    Four of ``furnished_room``'s boxes, two spheres (r = 0.22 / 0.30 m), a
    capped cylinder (r = 0.28 m) and two yaw-rotated boxes, placed in the
    frustum of the bench orbit (from near the origin toward +z, pitched
    toward the ceiling side), so every orbit viewpoint still constrains
    all 6 DOF."""
    half = np.array([1.3, 1.1, 1.3], np.float32) * scale
    boxes = np.array(
        [
            [[-0.95, 0.40, -0.95], [-0.35, 1.10, -0.35]],  # crate, floor corner
            [[-0.20, -1.10, 0.60], [0.40, -0.50, 1.20]],  # cabinet, ceiling side
            [[-1.25, -0.20, 0.20], [-0.85, 0.30, 0.80]],  # shelf on -x wall
            [[0.85, -0.40, -0.60], [1.25, 0.20, 0.00]],  # shelf on +x wall
        ],
        np.float32,
    ) * scale
    spheres = np.array(
        [
            [0.35, -0.50, 0.95, 0.30],  # large ball, ceiling side +z
            [-0.50, -0.30, 1.00, 0.22],  # smaller ball, -x of it
        ],
        np.float32,
    ) * scale
    # a column hanging from the ceiling in the +x/+z sector
    cylinders = np.array([[0.75, 0.75, 0.28, -1.10, 0.20]], np.float32) * scale
    obbs = np.array(
        [
            [0.15, -0.85, 1.00, 0.35, 0.20, 0.18, 0.5236],  # slab rotated 30 degrees
            [-0.10, 0.25, 1.05, 0.22, 0.45, 0.15, 0.8727],  # tall crate rotated 50 degrees
        ],
        np.float32,
    ) * np.array([scale] * 6 + [1.0], np.float32)
    return half, boxes, spheres, cylinders, obbs


def flat_furnished_room():
    """The furnished room squeezed to a 1.5 m ceiling: every face,
    the ceiling too, is visible at |pitch| <= 0.35 from inside."""
    half, boxes = furnished_room()
    half = np.array([1.3, 0.75, 1.3], np.float32)
    boxes = boxes.copy()
    boxes[:, :, 1] *= 0.75 / 1.1
    return half, boxes


def coverage_sweep_poses(radius: float = 0.2) -> np.ndarray:
    """(542, 4, 4) tracked full-coverage trajectory for a flat room: a
    0.75-turn wall orbit at pitch 0 with a floor wedge (pitch -0.40) at
    its end, then another 0.75 turn and a ceiling wedge (pitch +0.40);
    each wedge ramps up over 72 frames, holds 60 and ramps back. The
    camera never returns to an already mapped sector."""

    def pose_of(yaw: float, pitch: float) -> np.ndarray:
        pos = np.array([radius * math.sin(yaw), 0.0, radius * math.cos(yaw)])
        return _pose(_look_rotation(yaw, pitch), pos)

    def wedge(poses, yaw, pitch, ramp=72, hold=60):
        for k in range(ramp):
            poses.append(pose_of(yaw, pitch * k / (ramp - 1)))
        for k in range(hold):
            poses.append(pose_of(yaw, pitch))
        for k in range(ramp):
            poses.append(pose_of(yaw, pitch * (1 - k / (ramp - 1))))

    poses = []
    for k in range(67):
        poses.append(pose_of(2.36 * k / 66, 0.0))
    wedge(poses, 2.36, -0.40)  # floor wedge, early: the freshest map
    for k in range(67):
        poses.append(pose_of(2.36 + 2.35 * k / 66, 0.0))
    wedge(poses, 4.71, 0.40)  # ceiling wedge
    return np.stack(poses)


def render_depth_stream(
    intr: Intrinsics,
    poses: np.ndarray,
    half_dims,
    boxes: Optional[np.ndarray] = None,
    noise: float = 0.0,
    seed: int = 0,
    spheres: Optional[np.ndarray] = None,
    cylinders: Optional[np.ndarray] = None,
    obbs: Optional[np.ndarray] = None,
    *,
    device="cuda",
) -> torch.Tensor:
    """(N, H, W) float32 depth stream on ``device``, with optional
    Kinect-like noise: sigma ``noise`` at 2 m, growing with depth squared.

    The noise samples come from ``np.random.default_rng(seed)`` on the
    host, frame by frame, and go to the device in float64: the frame is
    ``float32(d + n * (d / 2)^2)`` with the sum in float64, as the
    reference computes it in numpy (a float32 sum would round twice)."""
    device = on_device(device)
    rng = np.random.default_rng(seed)

    def as_t(x):
        return None if x is None else torch.as_tensor(np.asarray(x), dtype=torch.float32,
                                                      device=device)

    half, boxes_t, spheres_t, cyl_t, obbs_t = (as_t(x) for x in (half_dims, boxes, spheres,
                                                                  cylinders, obbs))
    frames = []
    for pose in poses:
        d = render_box_interior_depth(intr, as_t(pose), half, boxes_t, spheres=spheres_t,
                                      cylinders=cyl_t, obbs=obbs_t)
        if noise > 0:
            n = torch.from_numpy(rng.normal(scale=noise, size=tuple(d.shape))).to(device)
            h = d / 2.0
            noisy = d.to(torch.float64) + n * (h * h).to(torch.float64)
            d = torch.where(d > 0, noisy, torch.zeros_like(noisy)).to(torch.float32)
        frames.append(d)
    return torch.stack(frames)


def ground_truth_tsdf(
    resolution: int,
    size_m: float,
    origin: np.ndarray,
    half_dims: np.ndarray,
    trunc: float,
    *,
    device="cuda",
) -> torch.Tensor:
    """Exact truncated SDF of the box-room interior on the voxel grid,
    (R, R, R) float32 on ``device``: the signed distance of a point inside
    an axis-aligned box to its surface is ``min over axes of (half - |p|)``
    (positive inside, in free space, as the TSDF's sign). Computed in
    float64 and cast once, as the reference's numpy version."""
    device = on_device(device)
    voxel = size_m / resolution
    idx = (torch.arange(resolution, dtype=torch.float64, device=device) + 0.5) * voxel
    o = np.asarray(origin, np.float64)
    h = [float(v) for v in np.asarray(half_dims)]
    x, y, z = (o[k] + idx for k in range(3))
    dist = torch.minimum(
        torch.minimum((h[0] - x.abs())[:, None, None], (h[1] - y.abs())[None, :, None]),
        (h[2] - z.abs())[None, None, :],
    )
    return torch.clamp(dist / trunc, -1.0, 1.0).to(torch.float32)
