"""Median host milliseconds for a ``kinfu_step`` call, from the frame's
hand-over (its upload) to the call's return, over the window's untraced
frames: the step driver's dispatch, a steadier statistic of the pieces
that set ``fusion_fps`` on a host-bound card."""

from harness.stats import median


def read(ctx):
    win = getattr(ctx.run, "window", None)
    if win is None or not hasattr(win, "host_s"):
        return None
    vals = [s for s, t in zip(win.host_s, win.traced) if not t]
    return median(vals) * 1e3 if vals else None
