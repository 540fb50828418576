"""The traced window: ``torch.profiler`` over a stretch of the run, read
back as device intervals and the harness's own host spans.

Host spans are ranges named ``bench.<what>`` that the drivers open around
each call into the program (the frame upload, the step, a pass reset).
Device intervals are every kernel, copy and memset the profiler saw on
the card. Both are placed on the profiler's clock (nanoseconds).
"""

from __future__ import annotations

import bisect
import contextlib
import time
from collections import defaultdict
from typing import Dict, List, NamedTuple, Tuple

from harness.stats import union_seconds

SPAN_PREFIX = "bench."


class DeviceOp(NamedTuple):
    name: str
    start_ns: int
    end_ns: int


class Span(NamedTuple):
    name: str
    start_ns: int
    end_ns: int


class TraceData(NamedTuple):
    ops: List[DeviceOp]  # every device operation, by start
    spans: List[Span]  # the harness's host spans, by start
    window: Tuple[int, int]  # the traced window (ns)

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) * 1e-9

    def busy_s(self) -> float:
        lo, hi = self.window
        return union_seconds([(o.start_ns, o.end_ns) for o in self.ops], lo, hi) * 1e-9

    def device_seconds(self, match) -> float:
        """Summed device seconds of the operations whose name ``match``
        accepts."""
        return sum(o.end_ns - o.start_ns for o in self.ops if match(o.name)) * 1e-9

    def top_ops(self, n: int = 10) -> List[list]:
        by: Dict[str, int] = defaultdict(int)
        for o in self.ops:
            by[o.name] += o.end_ns - o.start_ns
        top = sorted(by.items(), key=lambda kv: -kv[1])[:n]
        return [[k, v * 1e-9] for k, v in top]

    def idle_by_span(self, n: int = 10) -> List[list]:
        """Idle device seconds in the window, summed by the host span the
        host was in when each gap began (``outside`` where none was)."""
        lo, hi = self.window
        merged = []
        for o in sorted(self.ops, key=lambda o: o.start_ns):
            s, e = max(o.start_ns, lo), min(o.end_ns, hi)
            if e <= s:
                continue
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        gaps = []
        cur = lo
        for s, e in merged:
            if s > cur:
                gaps.append((cur, s))
            cur = max(cur, e)
        if hi > cur:
            gaps.append((cur, hi))
        starts = [sp.start_ns for sp in self.spans]
        by: Dict[str, int] = defaultdict(int)
        for g0, g1 in gaps:
            by[self._span_at(g0, starts)] += g1 - g0
        top = sorted(by.items(), key=lambda kv: -kv[1])[:n]
        return [[k, v * 1e-9] for k, v in top]

    def _span_at(self, t: int, starts: List[int]) -> str:
        # the drivers' spans follow one another without nesting
        i = bisect.bisect_right(starts, t) - 1
        if i >= 0 and t < self.spans[i].end_ns:
            return self.spans[i].name[len(SPAN_PREFIX):]
        return "outside"


class Tracer:
    """``torch.profiler`` over a stretch of the run, recording the card's
    activity only (recording every host operation too would slow the
    host several times over). The host spans are the harness's own, on
    the system clock (``time.time_ns``), which is the clock the
    profiler's device timestamps are given in."""

    def __init__(self, device):
        import torch

        self.torch = torch
        self.cuda = device.type == "cuda"
        self.spans: List[Tuple[str, int, int]] = []
        self.prof = None

    def start(self) -> None:
        torch = self.torch
        if self.cuda:  # the stretch starts with no earlier work in flight
            torch.cuda.synchronize()
        act = torch.profiler.ProfilerActivity
        self.prof = torch.profiler.profile(activities=[act.CUDA if self.cuda else act.CPU])
        self.prof.__enter__()

    def stop(self) -> None:
        if self.cuda:
            self.torch.cuda.synchronize()
        self.prof.__exit__(None, None, None)

    @contextlib.contextmanager
    def span(self, name: str):
        t0 = time.time_ns()
        try:
            yield
        finally:
            self.spans.append((SPAN_PREFIX + name, t0, time.time_ns()))

    def read(self) -> TraceData:
        """Device operations and host spans on the profiler's clock; the
        window runs from the first span's start to the end of the last
        device operation or span."""
        from torch.autograd import DeviceType

        ops = []
        for e in self.prof.profiler.kineto_results.events():
            if e.device_type() == DeviceType.CUDA:
                start = int(e.start_ns())
                ops.append(DeviceOp(e.name(), start, start + int(e.duration_ns())))
        spans = sorted((Span(*sp) for sp in self.spans), key=lambda sp: sp.start_ns)
        if not spans:
            raise RuntimeError("the traced window holds no span")
        ops.sort(key=lambda o: o.start_ns)
        lo = spans[0].start_ns
        hi = max([sp.end_ns for sp in spans] + [o.end_ns for o in ops])
        return TraceData([o for o in ops if o.end_ns > lo], spans, (lo, hi))
