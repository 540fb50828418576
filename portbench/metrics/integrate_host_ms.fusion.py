"""Median host milliseconds a frame in the program's ``integrate``
span (the work-list prepass with the free split, the depth mips, K5 and
K4), over the extra pass that the program traces with the profiler off
(``harness/program_trace.py``, pass (a))."""

from harness import program_trace


def read(ctx):
    p = program_trace.passes(ctx)
    if p is None or "integrate" not in p.host_ms:
        return None
    return p.host_ms["integrate"][0]
