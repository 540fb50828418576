"""Scan pipeline: depth stream in, reference-layout room directory out.

A port of ``housescan_tpu/kinfu/scan.py``. ``scan_to_room_dir`` fuses a
recorded stream with ``kinfu_step``, then ``write_room_outputs`` extracts
the surface points, detects the wall planes and writes

    cloud_downsampled.pcd   interaction-resolution surface cloud
    cloud_bin.pcd           full-resolution surface cloud
    planes.txt              detected planes (PCL sign convention)
    cloud_plane_hull<k>.pcd per-plane boundary polygons
    mesh.ply                (optional) marching-tetrahedra mesh
    trajectory.npz          per-frame camera poses

which the reference's room stage (``housescan_tpu.rooms.load_room``)
loads unchanged. The volume stays on the device; only the surface cloud,
the planes and the mesh's triangles come to the host.

Both paths fuse into the float32 (2, X, Y, Z) volume, as the reference's
scan does (its ``kinfu_init`` default). ``use_pallas`` picks the fusion
path and defaults to ``pallas_supported(resolution)``: a volume that
tiles into 128-voxel chunks takes the kernel path (K1, K3, K5, K4, K6);
any other takes the XLA path (K1, the XLA ICP loop with K2, the dense
integrate, the ray marcher). (The reference also sends every scan on its
CPU to the XLA path; the port's kernel path runs on either device.)
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional, Union

import numpy as np
import torch

from housescan_tpu_torch.capture.replay import DepthStream
from housescan_tpu_torch.config import Config
from housescan_tpu_torch.io.pcd import save_pcd
from housescan_tpu_torch.io.ply import save_ply
from housescan_tpu_torch.kinfu.marching_cubes import marching_cubes
from housescan_tpu_torch.kinfu.pipeline import kinfu_init, kinfu_step, pallas_supported
from housescan_tpu_torch.kinfu.ransac import detect_planes_to_dir
from housescan_tpu_torch.kinfu.scan_checkpoint import load_scan_state, save_scan_state
from housescan_tpu_torch.kinfu.tsdf import TsdfVolume, extract_surface_points
from housescan_tpu_torch.utils.metrics import GLOBAL_METRICS

# The full-resolution cloud's cap: PCL KinFu's cloud buffer
# (``TsdfVolume::DEFAULT_CLOUD_BUFFER_SIZE``, 10,000,000 points). The cap
# keeps the first points in raster order (x slowest), so a cap below a
# room's surface drops the room's +x end: a fully scanned 2.7 m room at
# 512^3 has over 1,048,576 surface voxels (the reference's 1 << 20).
MAX_SURFACE_POINTS = 10_000_000


def scan_to_room_dir(
    stream: DepthStream,
    out_dir: Union[str, Path],
    config: Optional[Config] = None,
    init_pose: Optional[np.ndarray] = None,
    max_points_full: int = MAX_SURFACE_POINTS,
    downsample_to: int = 1 << 16,
    write_mesh: bool = False,
    use_pallas: Optional[bool] = None,
    progress: bool = False,
    checkpoint_every: int = 0,
    checkpoint_path: Optional[Union[str, Path]] = None,
    resume: bool = False,
    known_poses: Optional[np.ndarray] = None,
    *,
    device="cuda",
) -> Path:
    """Fuse a depth stream on ``device`` and write the room directory.
    Returns ``out_dir``.

    ``checkpoint_every=N`` writes a resumable checkpoint of the fusion
    state every N frames to ``checkpoint_path`` (default
    ``<out_dir>/scan_checkpoint.npz``); ``resume=True`` continues from it,
    skipping the frames already fused. ``known_poses`` ((N, 4, 4)
    camera-to-world) fuses each frame at its known pose instead of
    tracking. ``use_pallas`` picks the fusion path (default:
    ``pallas_supported`` of the configured resolution)."""
    config = config or Config()
    intr = stream.intrinsics
    tsdf_cfg = config.tsdf
    device = torch.device(device)
    if use_pallas is None:
        use_pallas = pallas_supported(tsdf_cfg.resolution)

    ckpt = Path(checkpoint_path) if checkpoint_path else Path(out_dir) / "scan_checkpoint.npz"
    start_frame = 0
    state = None
    poses = []
    if resume and ckpt.exists():
        state, start_frame, trajectory = load_scan_state(ckpt, intr, device=device)
        # restore the poses before the checkpoint: trajectory row k is frame k
        poses = list(trajectory)
        if len(poses) != start_frame:
            raise ValueError(
                f"scan checkpoint stores {len(poses)} poses but resumes at frame "
                f"{start_frame}; refusing to write a misaligned trajectory "
                "(v1 checkpoints have no trajectory - rescan)"
            )
        if progress:
            print(f"  resuming from {ckpt} at frame {start_frame}")
    if state is None:
        state = kinfu_init(
            intr,
            resolution=tsdf_cfg.resolution,
            size_m=tsdf_cfg.size_m,
            trunc=tsdf_cfg.trunc_dist,
            init_pose=init_pose,
            device=device,
        )
    # Poses and tracking flags stay on the device until a checkpoint
    # or the end of the stream, so the host never waits on a frame.
    new_poses, tracked = [], []
    for k, frame in enumerate(stream):
        if k < start_frame:
            continue
        state = kinfu_step(
            state,
            _to_device(frame, device),
            intr,
            iterations=config.icp.iterations,
            dist_threshold=config.icp.dist_threshold,
            angle_threshold=config.icp.angle_threshold,
            max_weight=tsdf_cfg.max_weight,
            z_min=config.camera.z_min,
            use_pallas=use_pallas,
            forced_pose=None if known_poses is None else known_poses[k],
        )
        new_poses.append(state.pose)
        tracked.append(state.last_tracked)
        if progress and not bool(state.last_tracked):
            print(f"  frame {k}/{len(stream)} TRACKING LOST "
                  f"(corr {int(state.last_corr)}) - frame dropped")
        if checkpoint_every and (k + 1) % checkpoint_every == 0:
            traj = poses + list(torch.stack(new_poses).cpu().numpy())
            save_scan_state(state, k + 1, intr, ckpt, trajectory=np.stack(traj))
        if progress and k % 10 == 0:
            print(f"  frame {k}/{len(stream)} icp_rmse={float(state.last_rmse) * 1000:.2f}mm")
    if new_poses:
        poses += list(torch.stack(new_poses).cpu().numpy())
        n_dropped = int((~torch.stack(tracked)).sum())
        if progress and n_dropped:
            print(f"  {n_dropped} frame(s) dropped to tracking loss")

    return write_room_outputs(
        state.volume,
        poses,
        out_dir,
        config=config,
        icp_rmse=float(state.last_rmse),
        max_points_full=max_points_full,
        downsample_to=downsample_to,
        write_mesh=write_mesh,
    )


def _to_device(frame: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host depth frame on ``device``; to the card from pinned memory
    without blocking, so the upload does not wait for queued work."""
    t = torch.from_numpy(np.ascontiguousarray(frame, np.float32))
    if device.type != "cuda":
        return t
    return t.pin_memory().to(device, non_blocking=True)


def write_room_outputs(
    volume: TsdfVolume,
    poses,
    out_dir: Union[str, Path],
    config: Optional[Config] = None,
    icp_rmse: float = 0.0,
    max_points_full: int = MAX_SURFACE_POINTS,
    downsample_to: int = 1 << 16,
    write_mesh: bool = False,
) -> Path:
    """Extract the fused surface and write the reference-layout room
    directory (clouds, planes.txt + hulls, trajectory, optional mesh).

    With tracing on (``utils/metrics.GLOBAL_METRICS``) the export is the
    span ``export`` with the children ``export.surface``,
    ``export.ransac`` (the planes, the hulls and planes.txt; its child
    ``export.ransac.hulls`` is the hulls alone), ``export.mesh`` and
    ``export.writes``, and counts ``export.surface_points``,
    ``export.planes``, ``export.hull_points`` (``kinfu/ransac.plane_hulls``)
    and ``export.mesh_triangles`` from values it already holds."""
    config = config or Config()
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    dev = volume.data.device

    with GLOBAL_METRICS.span("export"):
        with GLOBAL_METRICS.span("export.surface"):
            full_dev = extract_surface_points(volume, max_points=max_points_full)
            full = full_dev.cpu().numpy()
        GLOBAL_METRICS.count("export.surface_points", len(full))
        if len(full) > downsample_to:
            idx = np.random.default_rng(0).choice(len(full), downsample_to, replace=False)
            down = full[idx]
        else:
            down = full
        with GLOBAL_METRICS.span("export.writes"):
            save_pcd(out_dir / "cloud_bin.pcd", full)
            save_pcd(out_dir / "cloud_downsampled.pcd", down)
        with GLOBAL_METRICS.span("export.ransac"):
            det = detect_planes_to_dir(
                torch.from_numpy(down).to(dev),
                out_dir,
                max_planes=config.ransac.max_planes,
                n_hypotheses=config.ransac.n_hypotheses,
                inlier_threshold=config.ransac.inlier_threshold,
                min_inliers=max(int(config.ransac.min_inlier_fraction * len(down)), 50),
            )
        GLOBAL_METRICS.count("export.planes", det.n_planes)
        with GLOBAL_METRICS.span("export.writes"):
            np.savez(
                out_dir / "trajectory.npz",
                poses=np.stack(poses) if len(poses) else np.zeros((0, 4, 4), np.float32),
                icp_rmse=icp_rmse,
            )
        if write_mesh:
            with GLOBAL_METRICS.span("export.mesh"):
                mesh = marching_cubes(volume)
            GLOBAL_METRICS.count("export.mesh_triangles", len(mesh.faces))
            with GLOBAL_METRICS.span("export.writes"):
                save_ply(out_dir / "mesh.ply", mesh)
    return out_dir
