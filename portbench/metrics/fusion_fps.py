"""Frames fused a second: every frame of the window (pass resets
included) over the window's seconds, host clock, the window ending when
the card has finished its last frame."""


def read(ctx):
    win = getattr(ctx.run, "window", None)
    if win is None or not hasattr(win, "frames"):
        return None
    return win.frames / win.seconds
