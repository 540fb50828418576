"""The program's building spans and counters over one extra building of a
traced building run.

``kinfu/building.scan_building`` opens the span ``building`` around the
whole call: ``building.room`` a scanned room (its fusion steps and
export nest inside), then ``building.assembly`` with its children
``building.assembly.load``, ``.fit``, ``.arrange``, ``.optimize`` and
``.xf``; it counts ``building.rooms``, ``building.fitted_rooms``,
``building.wall_connections`` and ``building.fit_iterations``. After a
traced run's window and check, ``building`` makes, the first time a
reader asks, one building with the program's tracing on and the
profiler off, and reads each span's host milliseconds (a room's: the
median over the rooms) and each counter's value.

A program without the building spans gives nothing to read: the
readers find no ``building`` span and return None.
"""

from __future__ import annotations

from collections import defaultdict
from types import SimpleNamespace
from typing import Optional

from harness import program_trace, spec
from harness.stats import median

ROOT_SPAN = "building"


def building(ctx) -> Optional[SimpleNamespace]:
    """The traced building of the run in ``ctx``, made once and kept on
    ``ctx.run.building_trace``: ``host_ms`` by span name (a building's
    summed ms; ``building.room``, the median room's), ``counters`` by
    name; None where the program records no spans or the run made no
    building."""
    res = ctx.run
    if hasattr(res, "building_trace"):
        return res.building_trace
    res.building_trace = None
    metrics = program_trace.program_metrics()
    prog = getattr(res, "prog", None)
    if metrics is None or prog is None:
        return None
    metrics.drain()
    metrics.enable()
    try:
        drv = spec.driver(ctx.cell.traffic["kind"])
        prog.build(res.inputs, res.tmp / "traced", SimpleNamespace(hand=[], ends=[]),
                   drv._orbit._Clock(prog.device))
    finally:
        metrics.disable()
    rec = metrics.drain()
    spans = rec["spans"]
    if not any(sp.name == ROOT_SPAN for sp in spans):
        return None
    host = defaultdict(float)
    rooms = []
    for sp in spans:
        ms = (sp.end_ns - sp.start_ns) * 1e-6
        host[sp.name] += ms
        if sp.name == "building.room":
            rooms.append(ms)
    host_ms = {k: v for k, v in host.items() if k.startswith(ROOT_SPAN)}
    if rooms:
        host_ms["building.room"] = median(rooms)
    counters = defaultdict(float)
    for c in rec["counters"]:
        if c.name.startswith(ROOT_SPAN + "."):
            counters[c.name] += float(c.value)
    out = SimpleNamespace(host_ms=host_ms, counters=dict(counters), rooms=len(rooms))
    res.building_trace = out
    res.notes["program_building_host_ms"] = {k: round(v, 4) for k, v in host_ms.items()}
    res.notes["program_building_counters"] = dict(out.counters)
    return out
