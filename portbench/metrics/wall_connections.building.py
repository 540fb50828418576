"""Wall connections a building makes (the program's
``building.wall_connections`` counter: ``len(scene.connected_walls)``
after the rooms are placed), in the extra building that the program
traces with the profiler off (``harness/building_trace.py``)."""

from harness import building_trace


def read(ctx):
    b = building_trace.building(ctx)
    if b is None or "building.wall_connections" not in b.counters:
        return None
    return b.counters["building.wall_connections"]
