"""Median host milliseconds a scan in the program's ``export.ransac`` span
(RANSAC's rounds, the hulls, planes.txt and the hull files), over the
extra scans that the program traces with the profiler off
(``harness/scan_trace.py``, pass (a))."""

from harness import scan_trace


def read(ctx):
    p = scan_trace.passes(ctx)
    if p is None or "export.ransac" not in p.host_ms:
        return None
    return p.host_ms["export.ransac"]
