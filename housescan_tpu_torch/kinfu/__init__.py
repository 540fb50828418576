"""KinFu tracking and fusion (camera, volume, preprocess, maps, ICP, the
step) and the scan stage (surface points, RANSAC, marching tetrahedra,
checkpoints, the room directory)."""

from housescan_tpu_torch.kinfu.camera import Intrinsics
from housescan_tpu_torch.kinfu.pipeline import KinFuState, kinfu_init, kinfu_step
from housescan_tpu_torch.kinfu.tsdf import TsdfVolume, tsdf_integrate, tsdf_new
from housescan_tpu_torch.kinfu.raycast import raycast
from housescan_tpu_torch.kinfu.icp import icp_track

__all__ = [
    "Intrinsics",
    "KinFuState",
    "kinfu_init",
    "kinfu_step",
    "TsdfVolume",
    "tsdf_integrate",
    "tsdf_new",
    "raycast",
    "icp_track",
]
