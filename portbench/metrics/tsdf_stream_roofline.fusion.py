"""K4's least time over its device time, over the traced pass: the
bound of the chunks each frame's truncation band reaches, read and
written once (``work/tsdf_stream.py``), at 3.35 TB/s and 67 TFLOP/s
float32 (the card's power limit is in the result's ``device``), over the
summed time of the ``tsdf_stream_kernel`` launches the profiler saw in
the same frames."""

import torch

from harness.peaks import bound
from metrics.work import tsdf_stream


def read(ctx):
    tr = ctx.trace
    win = getattr(ctx.run, "window", None)
    if tr is None or win is None:
        return None
    k4_s = tr.device_seconds(lambda name: "tsdf_stream_kernel" in name)
    if k4_s <= 0:
        return None
    inputs, config = ctx.run.inputs, ctx.run.config
    n = inputs.frames_mm.shape[0]
    cam, vol = config["camera"], config["volume"]
    dev = torch.device("cuda") if torch.cuda.is_available() else torch.device("cpu")
    least = 0.0
    for k, traced in enumerate(win.traced):
        if not traced or not bool(win.tracked[k]):
            continue  # a dropped frame integrates nothing
        depth = inputs.frames_mm[k % n].to(dev).to(torch.float32) * float(cam["depth_scale"])
        work = tsdf_stream.frame_work(depth, inputs.poses[k % n], cam, int(vol["resolution"]),
                                      float(vol["size_m"]), float(vol["trunc"]))
        least += bound(*work).seconds
    return 100.0 * least / k4_s
