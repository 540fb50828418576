"""Host milliseconds of the program's ``building.assembly.fit`` span (one
batched ``fit_cuboid_batch`` for every room with 8 corners, then
``apply_cuboid_fit`` a room) in the extra building that the program
traces with the profiler off (``harness/building_trace.py``)."""

from harness import building_trace


def read(ctx):
    b = building_trace.building(ctx)
    if b is None or "building.assembly.fit" not in b.host_ms:
        return None
    return b.host_ms["building.assembly.fit"]
