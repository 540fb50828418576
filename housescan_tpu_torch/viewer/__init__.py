"""Headless viewer: picking and offscreen rendering of a scene."""

from housescan_tpu_torch.viewer.scene import PickResult, pick, visible_objects
from housescan_tpu_torch.viewer.render import frame_scene, look_at_pose, render_scene

__all__ = [
    "PickResult",
    "pick",
    "visible_objects",
    "render_scene",
    "look_at_pose",
    "frame_scene",
]
