"""Device milliseconds a frame of the kernels, copies and memsets that
the program launched inside its ``raycast`` span, over the extra pass
that it traces under the profiler (``harness/program_trace.py``, pass
(b))."""

from harness import program_trace


def read(ctx):
    p = program_trace.passes(ctx)
    if p is None or not p.launches:
        return None
    return p.device_ms.get("raycast", 0.0)
