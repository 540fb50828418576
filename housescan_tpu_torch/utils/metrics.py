"""Structured metrics and timing: a copy of
``housescan_tpu/utils/metrics.py``.

Named metrics with JSONL emission and counters, gauges and timers
(``Metrics``, ``GLOBAL_METRICS``); the TSDF occupancy of a port volume;
``device_trace`` on ``torch.profiler`` in place of the reference's
``jax.profiler``.

Beyond the reference: the fusion step's own tracing. ``Metrics.span``
records named, nested host intervals on ``time.time_ns`` (the clock of
``torch.profiler``'s device timestamps), and ``Metrics.count`` keeps
device-side counters (a tensor the step already made) unread until
``drain``, so tracing adds no host synchronisation. Both are off until
``enable``: then ``span`` returns one shared no-op context and ``count``
returns at once.
"""

from __future__ import annotations

import json
import time
from collections import defaultdict
from contextlib import contextmanager
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, NamedTuple, Optional, Union

import torch


class SpanRecord(NamedTuple):
    """One closed span: ``parent`` is the index in the same drained list
    of the span that was open around it (-1: none), ``frame`` the
    identifier shared by every span under one outermost span (one
    ``kinfu_step`` call)."""

    name: str
    parent: int
    frame: int
    start_ns: int
    end_ns: int


class CounterRecord(NamedTuple):
    """One counter reading: ``frame`` is the frame of the span open when
    it was counted (the last one's where none was)."""

    name: str
    frame: int
    value: Union[int, float]


class _NoSpan:
    """The span of disabled tracing: one shared object that does nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


# A reload of this module in place (``devloop.reload_framework``, which
# the reference's reload also runs over this package) keeps the shared
# objects, so modules that imported them by name before it and those that
# import them after it hold the same ones.
NO_SPAN = globals().get("NO_SPAN") or _NoSpan()


class _Span:
    __slots__ = ("metrics", "name", "index")

    def __init__(self, metrics: "Metrics", name: str):
        self.metrics = metrics
        self.name = name

    def __enter__(self):
        m = self.metrics
        if m._open:
            parent = m._open[-1]
        else:
            parent = -1
            m._frame += 1
        self.index = len(m._spans)
        m._spans.append([self.name, parent, m._frame, time.time_ns(), 0])
        m._open.append(self.index)
        return self

    def __exit__(self, *exc):
        m = self.metrics
        m._spans[self.index][4] = time.time_ns()
        m._open.pop()
        return False


@dataclass
class Metrics:
    values: Dict[str, List[float]] = field(default_factory=lambda: defaultdict(list))
    sink_path: Optional[Path] = None
    tracing: bool = field(default=False, init=False)
    _spans: list = field(default_factory=list, init=False, repr=False)
    _open: list = field(default_factory=list, init=False, repr=False)
    _counters: list = field(default_factory=list, init=False, repr=False)
    _frame: int = field(default=0, init=False, repr=False)

    def enable(self) -> None:
        """Start recording spans and counters."""
        self.tracing = True

    def disable(self) -> None:
        """Stop recording; what was recorded waits for ``drain``."""
        self.tracing = False

    def span(self, name: str):
        """A context manager recording the host interval ``name`` as a
        child of the span open around it (one shared no-op while tracing
        is off)."""
        if not self.tracing:
            return NO_SPAN
        return _Span(self, name)

    def count(self, name: str, value) -> None:
        """Record ``value``, a number or a tensor the caller made, under
        the current frame; a tensor is kept as it is and read by
        ``drain``."""
        if not self.tracing:
            return
        self._counters.append((name, self._frame, value))

    def drain(self) -> Dict[str, list]:
        """The spans (``SpanRecord``, by start) and counters
        (``CounterRecord``) recorded since the last drain, as plain
        Python data, then forget them. The counters' tensors are read
        here, with one synchronisation a device."""
        if self._open:
            raise RuntimeError(f"drain() inside open spans {[self._spans[i][0] for i in self._open]}")
        values = [v for _, _, v in self._counters]
        by_device: Dict[torch.device, List[int]] = defaultdict(list)
        for i, v in enumerate(values):
            if isinstance(v, torch.Tensor):
                by_device[v.device].append(i)
        for idx in by_device.values():
            got = torch.stack([values[i].reshape(()).to(torch.float64) for i in idx]).tolist()
            for i, g in zip(idx, got):
                values[i] = g if values[i].is_floating_point() else int(g)
        out = {
            "spans": [SpanRecord(*sp) for sp in self._spans],
            "counters": [CounterRecord(n, f, v) for (n, f, _), v in zip(self._counters, values)],
        }
        self._spans, self._counters = [], []
        return out

    def observe(self, name: str, value: float, **tags) -> None:
        self.values[name].append(float(value))
        if self.sink_path is not None:
            with open(self.sink_path, "a") as f:
                f.write(
                    json.dumps({"ts": time.time(), "metric": name, "value": float(value), **tags})
                    + "\n"
                )

    @contextmanager
    def timer(self, name: str, **tags):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.observe(name, time.perf_counter() - t0, **tags)

    def summary(self) -> Dict[str, Dict[str, float]]:
        out = {}
        for name, vals in self.values.items():
            if not vals:
                continue
            s = sorted(vals)
            out[name] = {
                "count": len(vals),
                "mean": sum(vals) / len(vals),
                "min": s[0],
                "max": s[-1],
                "p50": s[len(s) // 2],
            }
        return out

    def report(self) -> str:
        lines = []
        for name, s in sorted(self.summary().items()):
            lines.append(
                f"{name}: n={s['count']} mean={s['mean']:.4g} "
                f"p50={s['p50']:.4g} min={s['min']:.4g} max={s['max']:.4g}"
            )
        return "\n".join(lines)


GLOBAL_METRICS = globals().get("GLOBAL_METRICS") or Metrics()  # kept by a reload, as NO_SPAN


def tsdf_occupancy(volume) -> float:
    """Fraction of observed voxels (weight > 0) of a volume in any
    layout: packed int32, float32 or bfloat16. The count is exact (an
    integer sum), so it is the same on every device."""
    weight = volume.weight
    return int((weight > 0).sum()) / weight.numel()


@contextmanager
def device_trace(log_dir: Union[str, Path]):
    """Profile the enclosed work with ``torch.profiler`` (host, and the
    card's kernels where CUDA is available) and write a Chrome trace,
    ``trace.json``, into ``log_dir`` (open it in Perfetto or
    chrome://tracing). Yields the profiler."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    log_dir = Path(log_dir)
    log_dir.mkdir(parents=True, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(str(log_dir / "trace.json"))
