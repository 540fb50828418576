"""Seconds from the process's start to the window's first timed item:
imports, the CUDA context, the kernel library (built on a checkout's
first run, loaded afterwards), the inputs made from the seed, and a
warm-up over the cell's own shapes."""


def read(ctx):
    return ctx.run.setup_s
