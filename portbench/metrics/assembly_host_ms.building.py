"""Host milliseconds of the program's ``building.assembly`` span in the
extra building that the program traces with the profiler off
(``harness/building_trace.py``): everything after the last room (load
and corners, the cuboid fit, the grid and its walls, the solve, the .xf
files)."""

from harness import building_trace


def read(ctx):
    b = building_trace.building(ctx)
    if b is None or "building.assembly" not in b.host_ms:
        return None
    return b.host_ms["building.assembly"]
