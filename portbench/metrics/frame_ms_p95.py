"""95th percentile over every frame of the window of the time from the
frame's hand-over to the program (host clock, before its upload) to the
completion on the card of a CUDA event recorded right after its step."""

from harness.stats import percentile


def read(ctx):
    win = getattr(ctx.run, "window", None)
    if win is None or not getattr(win, "frame_s", None):
        return None
    return percentile(win.frame_s, 95.0) * 1e3
