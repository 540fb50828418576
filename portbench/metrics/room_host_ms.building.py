"""Median host milliseconds a room in the program's ``building.room`` span
(the room's fusion at its known poses, its export without a mesh and the
building checkpoint's write), over the rooms of the extra building that
the program traces with the profiler off (``harness/building_trace.py``)."""

from harness import building_trace


def read(ctx):
    b = building_trace.building(ctx)
    if b is None or "building.room" not in b.host_ms:
        return None
    return b.host_ms["building.room"]
