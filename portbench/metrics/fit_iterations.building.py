"""The cuboid fit's Nelder-Mead iterations in a building (the program's
``building.fit_iterations`` counter: the longest instance of each of the
fit's two batched stages, summed), in the extra building that the
program traces with the profiler off (``harness/building_trace.py``)."""

from harness import building_trace


def read(ctx):
    b = building_trace.building(ctx)
    if b is None or "building.fit_iterations" not in b.counters:
        return None
    return b.counters["building.fit_iterations"]
