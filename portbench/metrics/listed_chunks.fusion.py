"""Chunks a frame on the integrate's work list (the program's
``integrate.listed_chunks`` counter, K4's work), the mean over the
tracked frames of the extra pass that the program traces with the
profiler off (``harness/program_trace.py``, pass (a))."""

from harness import program_trace


def read(ctx):
    p = program_trace.passes(ctx)
    vals = None if p is None else p.counters.get("integrate.listed_chunks")
    if not vals:
        return None
    kept = [v for v, t in zip(vals, p.tracked) if t]
    return sum(kept) / len(kept) if kept else None
