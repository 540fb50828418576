"""Share of the traced window (the window's first pass) in which no
kernel, copy or memset ran on the card."""


def read(ctx):
    tr = ctx.trace
    if tr is None or tr.window_s <= 0 or not tr.ops:
        return None
    return 100.0 * (1.0 - tr.busy_s() / tr.window_s)
