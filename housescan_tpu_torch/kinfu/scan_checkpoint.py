"""Mid-scan checkpoint and resume of the fusion state.

A port of ``housescan_tpu/kinfu/scan_checkpoint.py`` with the same file:
one compressed .npz holding the whole ``KinFuState`` (the volume in
any layout: packed int32, float32, or bfloat16 by its bits as the
reference's file holds it; persistent planes, poses, model maps, flags), the per-frame trajectory so
far and a JSON manifest with the schema version, the next frame index,
the intrinsics and a structural fingerprint of the state layout. The
fingerprint string is built from the numpy dtype names, so it is the same
for the port's state as for the reference's, and a checkpoint written by
either package loads in the other. A resume with another schema, layout
or camera is refused. Schema v4; v1-v3 files migrate.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Optional, Tuple, Union

import numpy as np
import torch

from housescan_tpu_torch.geometry.transform import full_fp32_matmul
from housescan_tpu_torch.io import host
from housescan_tpu_torch.kinfu.camera import Intrinsics
from housescan_tpu_torch.kinfu.pipeline import KinFuState, volume_from_numpy, volume_to_numpy
from housescan_tpu_torch.kinfu.tsdf import TsdfVolume

# v1: KinFuState with a velocity field, no trajectory.
# v2: velocity dropped; accumulated per-frame poses stored so a resumed
#     scan writes the same trajectory.npz as an uninterrupted one.
# v3: model maps stored channel-major packed (8, H, W) instead of three
#     interleaved arrays; v2 checkpoints migrate.
# v4: last_tracked tracking-loss flag added; v1-v3 migrate with True.
SCAN_SCHEMA_VERSION = 4


def _state_fingerprint(state: KinFuState) -> str:
    parts = [f"v{SCAN_SCHEMA_VERSION}"]
    for name in KinFuState._fields:
        leaf = getattr(state, name)
        if name == "volume":
            dtype = str(leaf.data.dtype).replace("torch.", "")
            parts.append("volume:" + ",".join(TsdfVolume._fields) + f":{leaf.data.dim()}d:{dtype}")
        else:
            arr = host(leaf)
            parts.append(f"{name}:{arr.ndim}d:{arr.dtype}")
    return "|".join(parts)


def save_scan_state(
    state: KinFuState,
    frame_index: int,
    intr: Intrinsics,
    path: Union[str, Path],
    trajectory: Optional[np.ndarray] = None,
) -> Path:
    """Write a resumable scan checkpoint; ``trajectory`` is the
    (frame_index, 4, 4) stack of the poses so far."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    manifest = {
        "schema_version": SCAN_SCHEMA_VERSION,
        "fingerprint": _state_fingerprint(state),
        "frame_index": int(frame_index),
        "intrinsics": {
            "width": intr.width, "height": intr.height,
            "fx": intr.fx, "fy": intr.fy, "cx": intr.cx, "cy": intr.cy,
        },
    }
    arrays = {
        "volume_data": volume_to_numpy(state.volume.data),
        "volume_origin": host(state.volume.origin),
        "volume_voxel_size": host(state.volume.voxel_size),
        "volume_trunc": host(state.volume.trunc),
        "planes": host(state.planes),
        "pose": host(state.pose),
        "model_maps": host(state.model_maps),
        "model_pose": host(state.model_pose),
        "state_frame_index": host(state.frame_index),
        "last_rmse": host(state.last_rmse),
        "last_corr": host(state.last_corr),
        "last_tracked": host(state.last_tracked),
        "trajectory": (
            np.zeros((0, 4, 4), np.float32)
            if trajectory is None
            else np.asarray(trajectory, np.float32)
        ),
    }
    np.savez_compressed(path, manifest=json.dumps(manifest), **arrays)
    return path


def _migrated_model_maps(z) -> np.ndarray:
    """v1/v2 interleaved (H, W, 3) vertices and normals and (H, W) valid
    -> packed (8, H, W) rows [depth, vertex xyz, normal xyz, valid]. The
    depth row was not stored; only exports read it, so it is zero."""
    v, n, valid = z["model_vertices"], z["model_normals"], z["model_valid"]
    return np.concatenate(
        [
            np.zeros((1,) + valid.shape, np.float32),
            np.moveaxis(np.asarray(v, np.float32), -1, 0),
            np.moveaxis(np.asarray(n, np.float32), -1, 0),
            np.asarray(valid, np.float32)[None],
        ]
    )


def load_scan_state(
    path: Union[str, Path], intr: Optional[Intrinsics] = None, *, device="cuda"
) -> Tuple[KinFuState, int, np.ndarray]:
    """Load a scan checkpoint onto ``device``: (state, next frame index,
    trajectory of the frames before it; empty for v1 files)."""
    device = torch.device(device)
    if device.type == "cuda":
        full_fp32_matmul()
    with np.load(Path(path), allow_pickle=False) as z:
        manifest = json.loads(str(z["manifest"]))
        version = manifest["schema_version"]
        if version not in (1, 2, 3, SCAN_SCHEMA_VERSION):
            raise ValueError(
                f"scan checkpoint schema v{version} != supported v{SCAN_SCHEMA_VERSION}"
            )
        if intr is not None:
            mi = manifest["intrinsics"]
            got = (mi["width"], mi["height"], mi["fx"], mi["fy"], mi["cx"], mi["cy"])
            want = (intr.width, intr.height, intr.fx, intr.fy, intr.cx, intr.cy)
            if got != want:
                raise ValueError(
                    f"scan checkpoint intrinsics {got} do not match the stream's {want}"
                )
        # v4 gets the exact fingerprint check below; v1-v3 predate it, so
        # check the arrays that version's layout must contain.
        required = [
            "volume_data", "volume_origin", "volume_voxel_size", "volume_trunc",
            "planes", "pose", "model_pose", "state_frame_index", "last_rmse", "last_corr",
        ]
        required += (
            ["model_maps"] if version >= 3
            else ["model_vertices", "model_normals", "model_valid"]
        )
        if version >= 2:
            required.append("trajectory")
        missing = [k for k in required if k not in z.files]
        if missing:
            raise ValueError(
                f"v{version} scan checkpoint is missing arrays {missing} "
                "(stale or layout-divergent file; refusing unsafe resume)"
            )
        if version == 1 and "velocity" not in z.files:
            raise ValueError("v1 scan checkpoint missing velocity field")

        def t(a):
            return torch.from_numpy(np.array(a)).to(device)

        model_maps = z["model_maps"] if version >= 3 else _migrated_model_maps(z)
        state = KinFuState(
            volume=TsdfVolume(
                data=volume_from_numpy(z["volume_data"]).to(device),
                origin=t(z["volume_origin"]),
                voxel_size=t(z["volume_voxel_size"]),
                trunc=t(z["volume_trunc"]),
            ),
            planes=t(z["planes"]),
            pose=t(z["pose"]),
            model_maps=t(model_maps),
            model_pose=t(z["model_pose"]),
            frame_index=t(z["state_frame_index"]),
            last_rmse=t(z["last_rmse"]),
            last_corr=t(z["last_corr"]),
            # v1-v3: the flag did not exist; a checkpoint was only ever
            # written after successfully fused frames
            last_tracked=(
                t(z["last_tracked"]) if version == SCAN_SCHEMA_VERSION
                else torch.ones((), dtype=torch.bool, device=device)
            ),
        )
        if version == SCAN_SCHEMA_VERSION and _state_fingerprint(state) != manifest["fingerprint"]:
            raise ValueError(
                "scan checkpoint layout does not match the current KinFuState schema "
                "(refusing unsafe resume)"
            )
        trajectory = (
            np.asarray(z["trajectory"], np.float32) if version >= 2
            else np.zeros((0, 4, 4), np.float32)
        )
    return state, int(manifest["frame_index"]), trajectory
