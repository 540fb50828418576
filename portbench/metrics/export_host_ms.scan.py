"""Median host milliseconds a scan in the program's ``export`` span (the
whole export: surface points, the clouds' and trajectory's files, RANSAC
with planes.txt and the hulls, the mesh and its file), over the extra
scans that the program traces with the profiler off
(``harness/scan_trace.py``, pass (a))."""

from harness import scan_trace


def read(ctx):
    p = scan_trace.passes(ctx)
    if p is None or "export" not in p.host_ms:
        return None
    return p.host_ms["export"]
