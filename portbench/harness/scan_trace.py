"""The program's export spans and counters over extra scans of a traced
scan run, read a scan at a time.

The export (``kinfu/scan.write_room_outputs``) opens the span ``export``
around its children ``export.surface``, ``export.ransac``,
``export.mesh`` and ``export.writes``, and counts
``export.surface_points``, ``export.planes`` and
``export.mesh_triangles``; ``export`` is an outermost span, so its
children and counters share its frame. After a traced scan run's window
and check, ``passes`` makes, the first time a reader asks:

  (a) ``SCANS_A`` scans with the program's tracing on and the profiler
      off: each span's host milliseconds summed within a scan, and each
      counter's value a scan;
  (b) one scan with the program's tracing on under the profiler: the
      device milliseconds of the kernels, copies and memsets launched
      inside each span (``harness/program_trace.py`` places each in the
      innermost span open at its launch; a span counts the operations of
      its children too).

A program without the export spans gives nothing to read: the readers
find no ``export`` span and return None.
"""

from __future__ import annotations

from collections import defaultdict
from types import SimpleNamespace
from typing import Dict, List, Optional, Sequence

import torch

from harness import program_trace, spec
from harness.stats import median
from harness.trace import Tracer

SCANS_A = 2
ROOT_SPAN = "export"


def per_scan_host_ms(spans: Sequence) -> Dict[str, List[float]]:
    """For every span name: its summed host ms in each ``export`` frame,
    in the order of those frames (0 where a frame lacks it)."""
    frames = [sp.frame for sp in sorted(spans, key=lambda s: s.start_ns) if sp.name == ROOT_SPAN]
    at = {f: j for j, f in enumerate(frames)}
    out: Dict[str, List[float]] = {}
    for sp in spans:
        if sp.frame in at:
            out.setdefault(sp.name, [0.0] * len(frames))[at[sp.frame]] += (
                (sp.end_ns - sp.start_ns) * 1e-6)
    return out


def device_ms_by_span(ops: Sequence, spans: Sequence, n_scans: int) -> Dict[str, float]:
    """Device ms a scan of the operations launched inside each span
    name, a span counting its children's."""
    owner, _, _ = program_trace.attribute(ops, spans)
    ch = program_trace.chains(spans)
    ns: Dict[str, int] = defaultdict(int)
    for o, i in zip(ops, owner):
        for name in set(ch[i] if i >= 0 else ()):
            ns[name] += o.end_ns - o.start_ns
    return {k: v * 1e-6 / max(n_scans, 1) for k, v in ns.items()}


def _scans(drv, prog, inputs, room, metrics, n: int) -> None:
    metrics.enable()
    try:
        for _ in range(n):
            drv.scan_once(prog, inputs, room, SimpleNamespace(hand=[], ends=[]),
                          drv._orbit._Clock(prog.device))
    finally:
        metrics.disable()


def passes(ctx) -> Optional[SimpleNamespace]:
    """Passes (a) and (b) of the scan run in ``ctx``, made once and kept
    on ``ctx.run.scan_trace``; None where the program records no spans or
    the run made no scan."""
    res = ctx.run
    if hasattr(res, "scan_trace"):
        return res.scan_trace
    res.scan_trace = None
    metrics = program_trace.program_metrics()
    prog = getattr(res, "prog", None)
    if metrics is None or prog is None:
        return None
    drv = spec.driver(ctx.cell.traffic["kind"])
    dev = prog.device
    room = res.tmp / "traced"
    metrics.drain()
    _scans(drv, prog, res.inputs, room, metrics, SCANS_A)
    rec_a = metrics.drain()
    tracer = Tracer(dev)
    tracer.start()
    try:
        for _ in range(3):  # the profiler's start-up, before the scan
            torch.zeros(1, device=dev).add_(1)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
        _scans(drv, prog, res.inputs, room, metrics, 1)
    finally:
        tracer.stop()
    rec_b = metrics.drain()
    spans_b = rec_b["spans"]
    lo = spans_b[0].start_ns if spans_b else 0
    ops = [o for o in program_trace.read_ops(tracer.prof, dev.type == "cuda")
           if (o.start_ns if o.launch_ns is None else o.launch_ns) >= lo]
    frames_a = [sp.frame for sp in sorted(rec_a["spans"], key=lambda s: s.start_ns)
                if sp.name == ROOT_SPAN]
    host = per_scan_host_ms(rec_a["spans"])
    counters = program_trace.counter_values(rec_a["counters"], frames_a)
    n_b = sum(1 for sp in spans_b if sp.name == ROOT_SPAN)
    out = SimpleNamespace(
        scans=len(frames_a),
        host_ms={k: median(v) for k, v in host.items()},
        counters={k: sum(v) / len(v) for k, v in counters.items()},
        device_ms=device_ms_by_span(ops, spans_b, n_b) if n_b else {},
    )
    res.scan_trace = out
    res.notes["program_export_host_ms"] = {k: round(v, 4) for k, v in out.host_ms.items()
                                           if k.startswith(ROOT_SPAN)}
    res.notes["program_export_device_ms"] = {k: round(v, 4) for k, v in out.device_ms.items()
                                             if k.startswith(ROOT_SPAN)}
    res.notes["program_export_counters"] = {k: round(v, 2) for k, v in out.counters.items()}
    return out
