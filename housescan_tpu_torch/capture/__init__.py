"""Depth streams: recorded (replay) and live (a camera, or a recorded
stream served as one)."""

from housescan_tpu_torch.capture.replay import DepthStream, ReplaySource, record_stream

__all__ = ["DepthStream", "ReplaySource", "record_stream"]
