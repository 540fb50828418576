"""Kernels, copies and memsets a frame that the program launched inside
its ``raycast`` span, over the extra pass that it traces under the
profiler (``harness/program_trace.py``, pass (b)): each operation goes to
the innermost program span open at its launch."""

from harness import program_trace


def read(ctx):
    p = program_trace.passes(ctx)
    if p is None or not p.launches:
        return None
    return p.launches.get("raycast", 0.0)
