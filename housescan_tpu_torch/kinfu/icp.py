"""Projective point-to-plane ICP camera tracking over the map pyramid.

Each level runs as one K3 call (``ops/icp_cuda.icp_level``): every
Gauss-Newton iteration of the level with the adaptive tight/wide gate
and the null-space-filtered 6x6 solve. The XLA fallback loop of the
reference (``kinfu/icp.py`` outside ``use_pallas``) is not ported yet.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import torch

from housescan_tpu_torch.kinfu import maps as mp
from housescan_tpu_torch.kinfu.camera import Intrinsics
from housescan_tpu_torch.ops.icp_cuda import BAND_H, icp_level

# Per level, finest first: association window (0 = +-1.5 px) and Tikhonov
# damping (coarse levels see few pixels of one or two walls).
WINDOWS = (0, 2, 4)
DAMPINGS = (3e-4, 3e-3, 1e-2)


class IcpResult(NamedTuple):
    pose: torch.Tensor  # (4, 4) refined camera-to-world
    rmse: torch.Tensor  # () final point-to-plane RMSE (meters)
    n_corr: torch.Tensor  # () int32 final correspondence count


def icp_track(
    live_maps: Sequence[torch.Tensor],
    model_maps: Sequence[torch.Tensor],
    prev_pose: torch.Tensor,
    intr: Intrinsics,
    iterations: Sequence[int] = (10, 5, 4),
    dist_threshold=0.10,
    angle_threshold: float = 0.5236,
    tight_threshold=None,
) -> IcpResult:
    """Track one frame. ``live_maps``/``model_maps`` are per-level
    channel-major (6, h, w) / (8, h, w) maps, level 0 = finest; the pose
    starts at ``prev_pose``, the model maps' render pose. ``iterations``
    and a sequence ``dist_threshold`` are indexed by level like WINDOWS
    and DAMPINGS, finest first; levels run coarse to fine.
    ``tight_threshold`` enables the adaptive gate."""
    n_levels = len(live_maps)
    pose = prev_pose
    dev = prev_pose.device
    rmse = torch.zeros((), dtype=torch.float32, device=dev)
    n_corr = torch.zeros((), dtype=torch.int32, device=dev)

    def per_level(seq, level):
        return seq[level] if len(seq) == n_levels else seq[-1]

    for level in range(n_levels - 1, -1, -1):
        iters = per_level(iterations, level)
        if iters == 0:
            continue
        if isinstance(dist_threshold, (tuple, list)):
            dist = per_level(dist_threshold, level)
        else:
            dist = dist_threshold
        packed = mp.pack_icp_inputs(
            live_maps[level],
            model_maps[level],
            mp.model_gradients(model_maps[level]),
            band_h=BAND_H,
        )
        pose, lvl_rmse, lvl_corr = icp_level(
            packed,
            pose,
            prev_pose,
            intr.level(level),
            n_iters=iters,
            window=per_level(WINDOWS, level),
            dist_threshold=dist,
            angle_threshold=angle_threshold,
            damping=per_level(DAMPINGS, level),
            tight_threshold=tight_threshold,
        )
        use = lvl_corr > 0
        rmse = torch.where(use, lvl_rmse, rmse)
        n_corr = torch.where(use, lvl_corr, n_corr)
    return IcpResult(pose, rmse, n_corr)
