"""Median host milliseconds a frame in the program's ``raycast`` span
(tile candidates, K6, the seam and skirt masks), over the extra pass
that the program traces with the profiler off
(``harness/program_trace.py``, pass (a))."""

from harness import program_trace


def read(ctx):
    p = program_trace.passes(ctx)
    if p is None or "raycast" not in p.host_ms:
        return None
    return p.host_ms["raycast"][0]
