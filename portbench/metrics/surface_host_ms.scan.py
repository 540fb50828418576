"""Median host milliseconds a scan in the program's ``export.surface`` span
(the zero-crossing surface points and their copy to the host), over the
extra scans that the program traces with the profiler off
(``harness/scan_trace.py``, pass (a))."""

from harness import scan_trace


def read(ctx):
    p = scan_trace.passes(ctx)
    if p is None or "export.surface" not in p.host_ms:
        return None
    return p.host_ms["export.surface"]
