"""Host milliseconds of the program's ``building.assembly.load`` span
(``load_room``, ``suggest_corners`` and ``adopt_bbox_corners`` for every
room) in the extra building that the program traces with the profiler
off (``harness/building_trace.py``)."""

from harness import building_trace


def read(ctx):
    b = building_trace.building(ctx)
    if b is None or "building.assembly.load" not in b.host_ms:
        return None
    return b.host_ms["building.assembly.load"]
