"""Kernels, copies and memsets on the card a frame over the traced pass
(its reset included): a count from the profiler."""


def read(ctx):
    tr = ctx.trace
    win = getattr(ctx.run, "window", None)
    if tr is None or not tr.ops or win is None or not any(getattr(win, "traced", [])):
        return None
    return len(tr.ops) / sum(1 for t in win.traced if t)
