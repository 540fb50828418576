"""ICP iterations a frame, every level summed (the program's
``icp.level<k>.iterations`` counters, K3's state row 18; the budget is
the configuration's, 10 + 5 + 4), the mean over the frames of the extra
pass that the program traces with the profiler off
(``harness/program_trace.py``, pass (a))."""

from harness import program_trace


def read(ctx):
    p = program_trace.passes(ctx)
    if p is None:
        return None
    levels = [v for k, v in p.counters.items()
              if k.startswith("icp.level") and k.endswith(".iterations")]
    if not levels:
        return None
    return sum(sum(v) for v in levels) / len(levels[0])
