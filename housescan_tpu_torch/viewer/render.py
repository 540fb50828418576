"""Offscreen scene rendering: z-buffer point splatting to an image file
(a copy of ``housescan_tpu/viewer/render.py``, numpy on the host).

Clouds are splatted in per-room colours, corners as markers, free planes
by their boundary polygons, all through one z-buffer; the image is
written as PNG where PIL is importable, else as binary PPM.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional, Tuple, Union

import numpy as np

from housescan_tpu_torch.kinfu.camera import Intrinsics
from housescan_tpu_torch.rooms.types import Scene

_ROOM_COLORS = np.array(
    [
        [0.90, 0.35, 0.30],
        [0.30, 0.75, 0.40],
        [0.30, 0.50, 0.95],
        [0.95, 0.80, 0.25],
        [0.75, 0.40, 0.90],
        [0.35, 0.85, 0.85],
        [0.95, 0.55, 0.20],
        [0.60, 0.70, 0.30],
    ]
)


def look_at_pose(eye: np.ndarray, target: np.ndarray) -> np.ndarray:
    """4x4 row-vector camera-to-world pose looking from ``eye`` at
    ``target``. Camera convention: x right, y down, z forward; world up
    is -Y (rooms/align.py), so camera-down aligns with world +Y.
    Degenerate (vertical) view directions fall back to world +X as
    right."""
    eye = np.asarray(eye, np.float64)
    target = np.asarray(target, np.float64)
    fwd = target - eye
    n = np.linalg.norm(fwd)
    fwd = fwd / n if n > 1e-9 else np.array([0.0, 0.0, 1.0])
    down = np.array([0.0, 1.0, 0.0])
    right = np.cross(down, fwd)
    rn = np.linalg.norm(right)
    if rn < 1e-6:  # looking straight up/down
        right = np.array([1.0, 0.0, 0.0])
    else:
        right = right / rn
    down = np.cross(fwd, right)
    pose = np.eye(4, dtype=np.float32)
    pose[0, :3] = right
    pose[1, :3] = down
    pose[2, :3] = fwd
    pose[3, :3] = eye
    return pose


def frame_scene(scene: Scene) -> Tuple[np.ndarray, np.ndarray]:
    """(eye, target) auto-framing the whole scene: look at the bounding
    box center from above-diagonal at ~2.2x the bounding radius (the
    reference started its camera pulled back on the scene too,
    Main.hs:877-898 camera state)."""
    pts = []
    for r in scene.rooms.values():
        p = np.asarray(r.cloud.points, np.float64)
        p = p[np.isfinite(p).all(axis=1)]
        if len(p):
            pts.append(p.min(axis=0))
            pts.append(p.max(axis=0))
        for _, c in r.corners:
            pts.append(np.asarray(c, np.float64))
    for p in scene.planes.values():
        if len(p.bounds):
            pts.append(p.bounds.min(axis=0))
            pts.append(p.bounds.max(axis=0))
    if not pts:
        return np.array([0.0, -1.0, -3.0]), np.zeros(3)
    lo = np.min(pts, axis=0)
    hi = np.max(pts, axis=0)
    center = (lo + hi) / 2
    radius = max(float(np.linalg.norm(hi - lo)) / 2, 0.5)
    # Above (-Y is up) and diagonally back.
    direction = np.array([-0.55, -0.55, -0.65])
    eye = center + direction / np.linalg.norm(direction) * radius * 2.2
    return eye, center


def render_scene(
    scene: Scene,
    pose: np.ndarray,
    intr: Intrinsics,
    out_path: Optional[Union[str, Path]] = None,
    point_px: int = 1,
    corner_px: int = 3,
) -> np.ndarray:
    """Render to an (H, W, 3) float image; optionally write PPM/PNG."""
    h, w = intr.height, intr.width
    img = np.full((h, w, 3), 0.08, np.float32)
    zbuf = np.full((h, w), np.inf, np.float32)

    pose = np.asarray(pose, np.float64)
    rot = pose[:3, :3]
    cam_t = pose[3, :3]

    def project(points):
        cam = (points - cam_t) @ rot.T
        z = cam[:, 2]
        ok = z > 0.05
        u = intr.fx * cam[:, 0] / np.maximum(z, 1e-9) + intr.cx
        v = intr.fy * cam[:, 1] / np.maximum(z, 1e-9) + intr.cy
        # NaN/inf points (e.g. invalid-marked cloud rows) must not reach
        # the int cast: comparisons with NaN are already False, but the
        # cast itself would warn and produce garbage indices.
        # In-frame cull: splat() clips coordinates, so without this an
        # off-screen point would smear along the image border.
        ok &= np.isfinite(u) & np.isfinite(v)
        ok &= (u >= 0) & (u < w) & (v >= 0) & (v < h)
        u = np.where(ok, u, 0.0)
        v = np.where(ok, v, 0.0)
        z = np.where(np.isfinite(z), z, np.inf)
        return u.astype(np.int32), v.astype(np.int32), z.astype(np.float32), ok

    def splat(u, v, z, ok, color, radius):
        for du in range(-radius + 1, radius):
            for dv in range(-radius + 1, radius):
                uu = np.clip(u + du, 0, w - 1)
                vv = np.clip(v + dv, 0, h - 1)
                sel = ok & (z < zbuf[vv, uu])
                zbuf[vv[sel], uu[sel]] = z[sel]
                img[vv[sel], uu[sel]] = color[sel] if color.ndim == 2 else color

    for k, room in enumerate(sorted(scene.rooms)):
        r = scene.rooms[room]
        base = _ROOM_COLORS[k % len(_ROOM_COLORS)]
        pts = np.asarray(r.cloud.points, np.float64)
        if len(pts):
            u, v, z, ok = project(pts)
            if r.cloud.colors is not None:
                splat(u, v, z, ok, np.asarray(r.cloud.colors, np.float32), point_px)
            else:
                splat(u, v, z, ok, base.astype(np.float32), point_px)
        # corners: white when the full 8 are placed (ref Main.hs:672-686)
        if r.corners:
            cs = np.stack([c for _, c in r.corners]).astype(np.float64)
            u, v, z, ok = project(cs)
            col = np.array([1.0, 1.0, 1.0]) if len(r.corners) == 8 else np.array([1.0, 0.3, 0.3])
            splat(u, v, z - 0.01, ok, col.astype(np.float32), corner_px)
        if r.suggested_corners:
            cs = np.stack([c for _, c in r.suggested_corners]).astype(np.float64)
            u, v, z, ok = project(cs)
            splat(u, v, z - 0.01, ok, np.array([0.2, 1.0, 0.2], np.float32), corner_px)

    # Free-standing planes: splat their boundary polygons (the reference
    # drew sPlanes alongside rooms, Main.hs:653-670).
    for pid in sorted(scene.planes):
        p = scene.planes[pid]
        if len(p.bounds):
            u, v, z, ok = project(np.asarray(p.bounds, np.float64))
            splat(u, v, z, ok, np.asarray(p.color, np.float32), point_px)

    if out_path is not None:
        write_image(out_path, img)
    return img


def write_image(path: Union[str, Path], img: np.ndarray) -> Path:
    """Write PNG if PIL is available, else binary PPM (always works)."""
    path = Path(path)
    arr = np.clip(img * 255.0, 0, 255).astype(np.uint8)
    try:
        from PIL import Image  # optional

        if path.suffix.lower() == ".ppm":
            raise ImportError
        Image.fromarray(arr).save(path)
    except ImportError:
        path = path.with_suffix(".ppm")
        with open(path, "wb") as f:
            f.write(f"P6\n{arr.shape[1]} {arr.shape[0]}\n255\n".encode())
            f.write(arr.tobytes())
    return path
