"""Mesh triangles a scan (the program's ``export.mesh_triangles``
counter: the faces of ``mesh.ply``), the mean over the extra scans that
the program traces with the profiler off (``harness/scan_trace.py``,
pass (a))."""

from harness import scan_trace


def read(ctx):
    p = scan_trace.passes(ctx)
    if p is None or "export.mesh_triangles" not in p.counters:
        return None
    return p.counters["export.mesh_triangles"]
