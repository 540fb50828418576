"""Surface points a scan (the program's ``export.surface_points``
counter: the points of ``cloud_bin.pcd``, at most the configuration's
``max_points_full``), the mean over the extra scans that the program
traces with the profiler off (``harness/scan_trace.py``, pass (a))."""

from harness import scan_trace


def read(ctx):
    p = scan_trace.passes(ctx)
    if p is None or "export.surface_points" not in p.counters:
        return None
    return p.counters["export.surface_points"]
