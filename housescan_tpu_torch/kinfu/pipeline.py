"""The KinFu tracking + fusion loop.

One ``kinfu_step``: bilateral filter (K1) -> pyramid -> model-map pyramid
-> per-level ICP -> tracking-loss gate -> integrate -> raycast, which
gives the next frame's model maps. The step runs entirely on the state's
device and never waits on it from the host. With
``utils.metrics.GLOBAL_METRICS`` enabled, the step records its spans
(``step``; ``track``, ``integrate``, ``raycast`` and their parts) and
counters, still without waiting on the card. Two paths, as in the
reference:

  * the kernel path (``use_pallas=True``, the port's default): ICP by K3,
    the work-list integrate with the plane refit and the free split (K5
    then K4), the plane raycast (K6) with seam masking. It needs a cubic
    volume that tiles into (8, 8, 128) chunks, in either layout;
  * the XLA path (``use_pallas=False``, the reference's default): the
    XLA ICP loop with the standalone solve (K2), the dense integrate
    (``tsdf.tsdf_integrate``) and the TSDF ray marcher
    (``kinfu/raycast.py``). It takes either volume layout at any
    resolution; the persistent planes are a (1, 1, 1, 16, 16) dummy when
    the volume does not tile.

Why the port's default differs: the reference defaults to the XLA path
because its kernels need a TPU. The port's kernels run on both devices
(the CPU takes their plain versions), and every port caller relies on
the kernel path.

Entry points put their tensors on ``device``, the card by default; a
caller that wants the CPU (the plain versions of every kernel) asks for
it with ``device="cpu"``.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import numpy as np
import torch

from housescan_tpu_torch.geometry.transform import full_fp32_matmul
from housescan_tpu_torch.geometry.transform import inverse_rigid  # noqa: F401  (the reference defines it here)
from housescan_tpu_torch.kinfu import maps as mp
from housescan_tpu_torch.kinfu.camera import Intrinsics
from housescan_tpu_torch.kinfu.icp import icp_track
from housescan_tpu_torch.kinfu.preprocess import build_pyramid
from housescan_tpu_torch.kinfu.raycast import raycast
from housescan_tpu_torch.kinfu.tsdf import TsdfVolume, tsdf_integrate, tsdf_new
from housescan_tpu_torch.ops.raycast_planes import raycast_planes
from housescan_tpu_torch.ops.tsdf_stream import planes_shape, tsdf_integrate_stream
from housescan_tpu_torch.utils.metrics import GLOBAL_METRICS


class KinFuState(NamedTuple):
    volume: TsdfVolume
    # (R/8, R/8, R/128, 16, 16) persistent sub-block planes; a dummy
    # (1, 1, 1, 16, 16) when the volume does not tile (XLA path only)
    planes: torch.Tensor
    pose: torch.Tensor  # (4, 4) current camera-to-world
    model_maps: torch.Tensor  # (8, H, W) raycast at model_pose
    model_pose: torch.Tensor  # (4, 4)
    frame_index: torch.Tensor  # () int32
    last_rmse: torch.Tensor  # () f32 ICP rmse of the last step
    last_corr: torch.Tensor  # () int32 ICP correspondences of the last step
    # () bool: False = tracking lost, the frame was dropped (not
    # integrated; pose and model unchanged)
    last_tracked: torch.Tensor


def kinfu_init(
    intr: Intrinsics,
    resolution: int = 512,
    size_m: float = 3.0,
    trunc: float = 0.03,
    origin=None,
    init_pose=None,
    dtype=torch.float32,
    *,
    device="cuda",
) -> KinFuState:
    """Fresh state with every tensor on ``device``; ``dtype`` picks the
    volume layout: ``torch.float32`` (2, X, Y, Z), the reference's
    default, the same in ``torch.bfloat16``, or ``torch.int32`` packed."""
    with GLOBAL_METRICS.span("init"):
        device = torch.device(device)
        if device.type == "cuda":
            full_fp32_matmul()
        vol = tsdf_new(resolution, size_m, trunc, origin, dtype, device=device)
        planes_dims = (planes_shape(resolution) if pallas_supported(resolution)
                       else (1, 1, 1, 16, 16))
        pose = (
            torch.eye(4, dtype=torch.float32, device=device)
            if init_pose is None
            else torch.as_tensor(np.asarray(init_pose), dtype=torch.float32).to(device).clone()
        )
        return KinFuState(
            volume=vol,
            planes=torch.zeros(planes_dims, dtype=torch.float32, device=device),
            pose=pose,
            model_maps=torch.zeros((mp.MODEL_ROWS, intr.height, intr.width),
                                   dtype=torch.float32, device=device),
            model_pose=pose.clone(),
            frame_index=torch.zeros((), dtype=torch.int32, device=device),
            last_rmse=torch.zeros((), dtype=torch.float32, device=device),
            last_corr=torch.zeros((), dtype=torch.int32, device=device),
            last_tracked=torch.ones((), dtype=torch.bool, device=device),
        )


def pallas_supported(volume_resolution: int) -> bool:
    """Whether the kernel path takes a volume of this resolution: it must
    tile into 128-voxel chunks. (The reference also requires a TPU; the
    port's kernels run on the CPU through their plain versions.)"""
    return volume_resolution % 128 == 0


def _integrate_dispatch(volume, planes, depth, pose, intr, max_weight, use_pallas):
    """(volume, planes) after one integrate: the work-list kernels refresh
    the persistent planes of the chunks they update; the dense integrate
    leaves them as they are. Both update the volume in place."""
    if use_pallas:
        return tsdf_integrate_stream(volume, planes, depth, pose, intr, max_weight=max_weight)
    return tsdf_integrate(volume, depth, pose, intr, max_weight=max_weight), planes


class Track(NamedTuple):
    """One frame's tracking verdict."""

    pose: torch.Tensor  # (4, 4) the pose it fuses at: the previous one where it was dropped
    tracked: torch.Tensor  # () bool, False where the frame was dropped
    rmse: torch.Tensor  # () f32 ICP rmse, 0 on the first frame and at a known pose
    corr: torch.Tensor  # () int32 ICP correspondences, likewise


def track_frame(raw_depth, intr: Intrinsics, state, start, voxel_size, icp, levels: int = 3,
                forced_pose=None) -> Track:
    """Track one (H, W) depth frame against ``state``'s model maps and gate
    it: the tracking policy of every fusion step (``kinfu_step`` and the
    sharded step) over ``state``'s ``pose``, ``model_maps`` and
    ``frame_index``. ``icp(live maps, model map pyramid, start, tight
    gate) -> (pose, rmse, n_corr)`` is the path's tracker, started from
    the pose ``start`` the model maps were rendered at. A ``forced_pose`` is taken as it is: no tracking, always
    fused. The first frame keeps the state's pose."""
    with GLOBAL_METRICS.span("track"):
        dev = raw_depth.device
        if forced_pose is not None:
            pose = torch.as_tensor(forced_pose, dtype=torch.float32)
            if pose.device.type == "cpu" and dev.type == "cuda":
                # from pinned memory: a pageable upload would wait for the card
                pose = pose.pin_memory()
            return Track(pose.to(dev, non_blocking=True),
                         torch.ones((), dtype=torch.bool, device=dev),
                         torch.zeros((), dtype=torch.float32, device=dev),
                         torch.zeros((), dtype=torch.int32, device=dev))
        with GLOBAL_METRICS.span("track.pyramid"):
            pyr = build_pyramid(raw_depth, intr, levels=levels)
        with GLOBAL_METRICS.span("track.model_pyramid"):
            model_pyr = mp.build_map_pyramid(state.model_maps, levels)
        is_first = state.frame_index == 0
        # Adaptive tight gate: half a voxel, floored at 6 mm; the finest
        # level's loose gate equals it, the coarser ones are 5 and 10 cm.
        tight = torch.clamp(0.5 * voxel_size, min=0.006)
        with GLOBAL_METRICS.span("track.icp"):
            icp_pose, icp_rmse, icp_corr = icp(list(pyr.maps), model_pyr, start, tight)
        with GLOBAL_METRICS.span("track.gate"):
            return _gate(raw_depth, intr, state, is_first, icp_pose, icp_rmse, icp_corr)


def _gate(raw_depth, intr: Intrinsics, state, is_first, icp_pose, icp_rmse, icp_corr) -> Track:
    """The tracking-loss gate of ``track_frame``."""
    new_pose = torch.where(is_first, state.pose, icp_pose)

    # Tracking-loss gate: drop the frame when the correspondence set
    # collapsed or the live view disagrees with the model (mean clipped
    # |live - model| depth over jointly valid pixels > 0.15 m), unless the
    # model itself was too sparse to track against (growth phase).
    min_corr = max(32, int(0.002 * intr.width * intr.height))
    model_valid = state.model_maps[mp.MD_VALID] > 0.5
    both_valid = (raw_depth > 0) & model_valid
    view_incons = torch.where(
        both_valid,
        torch.clamp((raw_depth - state.model_maps[mp.MD_DEPTH]).abs(), max=1.0),
        0.0,
    ).sum() / torch.clamp(both_valid.sum(), min=1)
    tracked = (
        is_first
        | ((icp_corr >= min_corr) & (view_incons <= 0.15))
        | (model_valid.sum() < 4 * min_corr)
    )
    return Track(torch.where(tracked, new_pose, state.pose), tracked,
                 torch.where(is_first, 0.0, icp_rmse),
                 torch.where(is_first, 0, icp_corr).to(torch.int32))


@torch.no_grad()
def kinfu_step(
    state: KinFuState,
    raw_depth: torch.Tensor,
    intr: Intrinsics,
    levels: int = 3,
    iterations: Tuple[int, ...] = (10, 5, 4),
    dist_threshold=None,
    angle_threshold: float = 0.5236,
    max_weight: float = 128.0,
    z_min: float = 0.3,
    max_raycast_steps: int = 256,
    use_pallas: bool = True,
    *,
    forced_pose=None,
) -> KinFuState:
    """Track and fuse one (H, W) depth frame. The volume and planes of
    ``state`` are updated IN PLACE (the reference donates them); every
    other field of the returned state is new.

    ``use_pallas`` picks the kernel path (True) or the XLA path (False;
    ``max_raycast_steps`` is its ray marcher's step count). ``forced_pose``
    (4, 4) fuses the frame at a known camera pose instead of tracking:
    ICP is skipped, rmse and correspondences are 0 and the frame always
    integrates."""
    vol = state.volume
    if use_pallas:
        if len(set(vol.dims)) != 1 or not pallas_supported(vol.dims[0]):
            raise ValueError("kinfu_step(use_pallas=True): needs a cubic volume tiling into "
                             "128-voxel chunks; use_pallas=False takes any volume")
    raw_depth = raw_depth.to(device=vol.data.device, dtype=torch.float32)

    def icp(live, model_pyr, start, tight):
        out = icp_track(live, model_pyr, start, intr, iterations=iterations,
                        dist_threshold=(tight, 0.05, 0.10) if dist_threshold is None
                        else dist_threshold,
                        angle_threshold=angle_threshold, tight_threshold=tight,
                        use_pallas=use_pallas)
        return out.pose, out.rmse, out.n_corr

    with GLOBAL_METRICS.span("step"):
        tr = track_frame(raw_depth, intr, state, state.model_pose, vol.voxel_size, icp, levels,
                         forced_pose)
        new_pose, tracked = tr.pose, tr.tracked
        depth_eff = torch.where(tracked, raw_depth, 0.0)

        with GLOBAL_METRICS.span("integrate"):
            volume, planes = _integrate_dispatch(
                vol, state.planes, depth_eff, new_pose, intr, max_weight, use_pallas
            )
        with GLOBAL_METRICS.span("raycast"):
            if use_pallas:
                model_maps = raycast_planes(planes, new_pose, intr, volume, z_min=z_min)
            else:
                rc = raycast(volume, new_pose, intr, z_min=z_min, max_steps=max_raycast_steps)
                model_maps = mp.model_from_hwc(rc.vertices, rc.normals, rc.valid, rc.depth)
        model_maps = torch.where(tracked, model_maps, state.model_maps)

        return KinFuState(
            volume=volume,
            planes=planes,
            pose=new_pose,
            model_maps=model_maps,
            model_pose=torch.where(tracked, new_pose, state.model_pose),
            frame_index=state.frame_index + 1,
            last_rmse=tr.rmse,
            last_corr=tr.corr,
            last_tracked=tracked,
        )


def kinfu_run(
    state: KinFuState,
    depth_stream: torch.Tensor,
    intr: Intrinsics,
    **step_kwargs,
) -> Tuple[KinFuState, torch.Tensor]:
    """Fuse an (N, H, W) stream: (final state, (N, 4, 4) poses)."""
    poses = []
    for i in range(depth_stream.shape[0]):
        state = kinfu_step(state, depth_stream[i], intr, **step_kwargs)
        poses.append(state.pose)
    return state, torch.stack(poses)


STATE_FIELDS = (
    "data", "origin", "voxel_size", "trunc", "planes", "pose", "model_maps",
    "model_pose", "frame_index", "last_rmse", "last_corr", "last_tracked",
)


def volume_from_numpy(data: np.ndarray) -> torch.Tensor:
    """A volume's ``data`` as a CPU tensor of its layout: packed int32,
    float32, or bfloat16. numpy has no bfloat16 of its own: an array from
    JAX carries the ``ml_dtypes`` one, and a bfloat16 volume read back
    from an .npy file (either package's) is a 2-byte void array; both are
    taken by their bits (the port does not import ``ml_dtypes``)."""
    if data.dtype.name == "bfloat16" or (data.dtype.kind == "V" and data.dtype.itemsize == 2):
        bits = np.ascontiguousarray(data).view(np.int16)
        return torch.from_numpy(bits.copy()).view(torch.bfloat16)
    if data.dtype not in (np.int32, np.float32):
        raise ValueError(f"a {data.dtype} volume has no layout (int32, float32 or bfloat16)")
    return torch.from_numpy(np.array(data))


def volume_to_numpy(data: torch.Tensor) -> np.ndarray:
    """A volume's ``data`` as a host array: int32 and float32 as they
    are, bfloat16 by its bits as a 2-byte void array (what numpy makes of
    the reference's bfloat16 in an .npy file), which ``volume_from_numpy``
    takes back."""
    data = data.detach().cpu()
    if data.dtype == torch.bfloat16:
        return data.view(torch.int16).numpy().view("V2")
    return data.numpy()


def state_from_numpy(d: Dict[str, np.ndarray], device="cuda") -> KinFuState:
    """KinFuState from numpy arrays keyed by ``STATE_FIELDS``; e.g. the
    fields of a reference state. ``data`` keeps its layout: packed int32
    (X, Y, Z), or float32 or bfloat16 (2, X, Y, Z) (``volume_from_numpy``)."""
    device = torch.device(device)
    if device.type == "cuda":
        full_fp32_matmul()

    def t(k, dtype):
        return torch.as_tensor(np.array(d[k]), dtype=dtype).to(device)

    return KinFuState(
        volume=TsdfVolume(
            data=volume_from_numpy(np.asarray(d["data"])).to(device),
            origin=t("origin", torch.float32),
            voxel_size=t("voxel_size", torch.float32),
            trunc=t("trunc", torch.float32),
        ),
        planes=t("planes", torch.float32),
        pose=t("pose", torch.float32),
        model_maps=t("model_maps", torch.float32),
        model_pose=t("model_pose", torch.float32),
        frame_index=t("frame_index", torch.int32),
        last_rmse=t("last_rmse", torch.float32),
        last_corr=t("last_corr", torch.int32),
        last_tracked=t("last_tracked", torch.bool),
    )


def state_to_numpy(state: KinFuState) -> Dict[str, np.ndarray]:
    """Inverse of ``state_from_numpy``; a bfloat16 volume comes as its
    bits (``volume_to_numpy``)."""
    vals = (
        state.volume.origin, state.volume.voxel_size,
        state.volume.trunc, state.planes, state.pose, state.model_maps,
        state.model_pose, state.frame_index, state.last_rmse,
        state.last_corr, state.last_tracked,
    )
    out = {k: v.detach().cpu().numpy() for k, v in zip(STATE_FIELDS[1:], vals)}
    return {"data": volume_to_numpy(state.volume.data), **out}
