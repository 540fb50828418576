"""K3's least time over its device time, over the traced pass: the
bound of every ICP level's maps read once (``work/icp_level.py``),
3.35 TB/s and 67 TFLOP/s float32 (the card's power limit is in the
result's ``device``), over the summed time of the ``icp_level_kernel``
launches the profiler saw in the same frames."""

import torch

from harness.peaks import bound
from metrics.work import icp_level


def read(ctx):
    tr = ctx.trace
    win = getattr(ctx.run, "window", None)
    if tr is None or win is None:
        return None
    k3_s = tr.device_seconds(lambda name: "icp_level_kernel" in name)
    if k3_s <= 0:
        return None
    inputs, config = ctx.run.inputs, ctx.run.config
    n = inputs.frames_mm.shape[0]
    scale = float(config["camera"]["depth_scale"])
    least = 0.0
    for k, traced in enumerate(win.traced):
        if not traced:
            continue  # every frame runs its levels, frame 0 and a dropped one too
        depth = inputs.frames_mm[k % n].to(torch.float32) * scale
        least += bound(*icp_level.frame_work(depth, int(config["icp"]["levels"]))).seconds
    return 100.0 * least / k3_s
