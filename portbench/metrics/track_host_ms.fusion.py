"""Median host milliseconds a frame in the program's ``track`` span
(``kinfu/pipeline.track_frame``: pyramid, model pyramid, ICP, gate), over
the extra pass that the program traces with the profiler off
(``harness/program_trace.py``, pass (a))."""

from harness import program_trace


def read(ctx):
    p = program_trace.passes(ctx)
    if p is None or "track" not in p.host_ms:
        return None
    return p.host_ms["track"][0]
