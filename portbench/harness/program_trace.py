"""The program's own spans and counters over two extra passes of a traced
run, read by layer.

The program (``housescan_tpu_torch.utils.metrics.GLOBAL_METRICS``)
records named, nested host spans on ``time.time_ns`` (the clock of the
profiler's device timestamps) and device-side counters it reads only
when drained. After a traced run's window and check, ``passes`` runs two
more passes of the cell's stream on a fresh state, the first time a
reader asks (per-layer metrics are read in traced runs only):

  (a) program tracing on, the profiler off: each span's host duration,
      and the counters;
  (b) program tracing on under the profiler (``harness.trace.Tracer``):
      each kernel, copy or memset goes to the innermost program span
      that launched it, found by the profiler's record of the launch on
      the host (the runtime call that shares the operation's correlation
      id), or, where the profiler has no such record, by the span open
      when the operation started; each idle gap goes to the innermost
      span the host was in when it began.

A program without these spans (it has no ``GLOBAL_METRICS.enable``)
gives nothing to read: ``passes`` returns None and runs nothing.
"""

from __future__ import annotations

from collections import defaultdict
from types import SimpleNamespace
from typing import Dict, List, NamedTuple, Optional, Sequence

import torch

from harness import spec
from harness.stats import median
from harness.trace import Tracer

OUTSIDE = "outside"
LAYERS = ("init", "track", "integrate", "raycast")  # and the step's own, "step"


class Op(NamedTuple):
    name: str
    start_ns: int
    end_ns: int
    launch_ns: Optional[int]  # host time of its launch, where the profiler recorded it


def program_metrics():
    """The program's metrics registry, or None where it records no spans."""
    try:
        from housescan_tpu_torch.utils.metrics import GLOBAL_METRICS
    except ImportError:
        return None
    if not all(hasattr(GLOBAL_METRICS, a) for a in ("enable", "disable", "span", "drain")):
        return None
    return GLOBAL_METRICS


# ---------------------------------------------------------------------------
# arithmetic on spans and operations (plain data; tested on the CPU)


def chains(spans: Sequence) -> List[tuple]:
    """Each span's name and its ancestors' names, innermost first."""
    out: List[tuple] = [()] * len(spans)
    # parents come before their children in start order, and a drained
    # list is in start order
    for i, sp in enumerate(spans):
        out[i] = (sp.name,) + (out[sp.parent] if sp.parent >= 0 else ())
    return out


def self_ns(spans: Sequence) -> List[int]:
    """Each span's duration less what its child spans cover."""
    own = [sp.end_ns - sp.start_ns for sp in spans]
    for sp in spans:
        if sp.parent >= 0:
            own[sp.parent] -= sp.end_ns - sp.start_ns
    return own


def innermost(spans: Sequence, times: Sequence[int]) -> List[int]:
    """For each time, the index of the innermost span open then
    ([start, end)), or -1. Spans nest, so a sweep with a stack does."""
    order = sorted(range(len(times)), key=lambda i: times[i])
    by_start = sorted(range(len(spans)), key=lambda i: (spans[i].start_ns, -spans[i].end_ns))
    out = [-1] * len(times)
    stack: List[int] = []
    k = 0
    for i in order:
        t = times[i]
        while k < len(by_start) and spans[by_start[k]].start_ns <= t:
            j = by_start[k]
            while stack and spans[stack[-1]].end_ns <= spans[j].start_ns:
                stack.pop()
            stack.append(j)
            k += 1
        while stack and spans[stack[-1]].end_ns <= t:
            stack.pop()
        out[i] = stack[-1] if stack else -1
    return out


def attribute(ops: Sequence[Op], spans: Sequence):
    """(innermost span index of each operation, operations placed by
    their launch, by their start)."""
    times = [o.launch_ns if o.launch_ns is not None else o.start_ns for o in ops]
    by_launch = sum(1 for o in ops if o.launch_ns is not None)
    return innermost(spans, times), by_launch, len(ops) - by_launch


def step_frames(spans: Sequence) -> List[int]:
    """The frame identifiers of the ``step`` spans, in order."""
    return [sp.frame for sp in sorted(spans, key=lambda s: s.start_ns) if sp.name == "step"]


def host_ms(spans: Sequence) -> Dict[str, List[float]]:
    """For every span name: [median a step frame of its summed duration,
    of its summed self time] in ms, over the frames of the ``step`` spans."""
    frames = step_frames(spans)
    own = self_ns(spans)
    dur: Dict[str, Dict[int, int]] = defaultdict(lambda: defaultdict(int))
    slf: Dict[str, Dict[int, int]] = defaultdict(lambda: defaultdict(int))
    for sp, s in zip(spans, own):
        dur[sp.name][sp.frame] += sp.end_ns - sp.start_ns
        slf[sp.name][sp.frame] += s
    out = {}
    for name in dur:
        if any(f in dur[name] for f in frames):
            out[name] = [median([dur[name][f] for f in frames]) * 1e-6,
                         median([slf[name][f] for f in frames]) * 1e-6]
    return out


def by_layer(ops: Sequence[Op], spans: Sequence, owner: Sequence[int]):
    """({layer: operations}, {layer: device ns}) for ``LAYERS``, each
    counting what runs under a span of that name; ``step`` counts the
    step's own operations (outside its layers), ``outside`` the rest."""
    ch = chains(spans)
    n: Dict[str, int] = defaultdict(int)
    ns: Dict[str, int] = defaultdict(int)
    for o, i in zip(ops, owner):
        names = ch[i] if i >= 0 else ()
        layer = next((x for x in reversed(names) if x in LAYERS),
                     "step" if "step" in names else OUTSIDE)
        n[layer] += 1
        ns[layer] += o.end_ns - o.start_ns
    return dict(n), dict(ns)


def idle_gaps(ops: Sequence[Op], spans: Sequence, window, n: int = 10) -> List[list]:
    """Idle device seconds in ``window`` by the innermost span the host
    was in when each gap began (``outside`` where none was)."""
    lo, hi = window
    merged: List[list] = []
    for o in sorted(ops, key=lambda o: o.start_ns):
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
    owner = innermost(spans, [g0 for g0, _ in gaps])
    by: Dict[str, int] = defaultdict(int)
    for (g0, g1), i in zip(gaps, owner):
        by[spans[i].name if i >= 0 else OUTSIDE] += g1 - g0
    top = sorted(by.items(), key=lambda kv: -kv[1])[:n]
    return [[k, v * 1e-9] for k, v in top]


def counter_values(counters: Sequence, frames: Sequence[int]) -> Dict[str, List[float]]:
    """Each counter's value for each frame of ``frames`` (summed within a
    frame; 0 where the frame did not count it)."""
    at = {f: j for j, f in enumerate(frames)}
    out: Dict[str, List[float]] = {}
    for c in counters:
        if c.frame in at:
            out.setdefault(c.name, [0.0] * len(frames))[at[c.frame]] += float(c.value)
    return out


# ---------------------------------------------------------------------------
# reading the profiler


def read_ops(prof, cuda: bool) -> List[Op]:
    """The profiled operations. On a card: every kernel, copy and memset,
    each with the host time of the runtime call that launched it where
    the profiler recorded one (same correlation id). On the CPU, whose
    operations run on the host as they are called: the outermost
    ``aten::`` operations, each launched at its start."""
    from torch.autograd import DeviceType

    events = list(prof.profiler.kineto_results.events())
    ops: List[Op] = []
    if cuda:
        launches = {}
        for e in events:
            if e.device_type() != DeviceType.CUDA and e.name().startswith("cu"):
                launches[int(e.correlation_id())] = int(e.start_ns())
        for e in events:
            if e.device_type() == DeviceType.CUDA:
                start = int(e.start_ns())
                t = launches.get(int(e.correlation_id()))
                if t is None:
                    t = launches.get(int(e.linked_correlation_id()))
                ops.append(Op(e.name(), start, start + int(e.duration_ns()), t))
    else:
        end = -1
        for e in sorted((e for e in events if e.name().startswith("aten::")),
                        key=lambda e: (int(e.start_ns()), -int(e.duration_ns()))):
            start = int(e.start_ns())
            if start < end:
                continue  # inside an operation already listed
            end = start + int(e.duration_ns())
            ops.append(Op(e.name(), start, end, start))
    ops.sort(key=lambda o: o.start_ns)
    return ops


# ---------------------------------------------------------------------------
# the passes


def _pass(drv, prog, inputs, scale, metrics, poses, tracked):
    """One pass of the stream on a fresh state, traced by the program;
    each frame's pose and tracked flag copied into ``poses``/``tracked``
    on the device. The caller drains the record (draining reads the
    counters on the device: after the profiler stops)."""
    dev = prog.device
    n = inputs.frames_mm.shape[0]
    metrics.drain()
    metrics.enable()
    try:
        state = prog.fresh(inputs.poses[0])
        for j in range(n):
            depth = drv.to_metres(inputs.frames_mm[j], dev, scale)
            state = prog(state, depth)
            poses[j].copy_(state.pose)
            tracked[j].copy_(state.last_tracked)
        del state
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    finally:
        metrics.disable()


def passes(ctx) -> Optional[SimpleNamespace]:
    """Passes (a) and (b) of the run in ``ctx``, made once and kept on
    ``ctx.run.program``; None where the program records no spans or the
    run has no window."""
    res = ctx.run
    if hasattr(res, "program"):
        return res.program
    res.program = None
    metrics = program_metrics()
    win = getattr(res, "window", None)
    if metrics is None or win is None or getattr(win, "state", None) is None:
        return None
    drv = spec.driver(ctx.cell.traffic["kind"])
    data = win.state.volume.data
    dev = data.device
    prog = drv.Program(res.config, dev, data.dtype)
    inputs = res.inputs
    scale = float(res.config["camera"]["depth_scale"])
    n = inputs.frames_mm.shape[0]
    poses = torch.zeros((2, n, 4, 4), dtype=torch.float32, device=dev)
    tracked = torch.zeros((2, n), dtype=torch.bool, device=dev)

    _pass(drv, prog, inputs, scale, metrics, poses[0], tracked[0])
    rec_a = metrics.drain()
    tracer = Tracer(dev)
    tracer.start()
    try:
        # the profiler's start-up, before the pass: on a card it has been
        # seen to miss the first few hundred operations of a stretch
        for _ in range(3):
            torch.zeros(1, device=dev).add_(1)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
        _pass(drv, prog, inputs, scale, metrics, poses[1], tracked[1])
    finally:
        tracer.stop()
    rec_b = metrics.drain()
    spans_a, spans_b = rec_a["spans"], rec_b["spans"]
    lo = spans_b[0].start_ns if spans_b else 0
    ops = [o for o in read_ops(tracer.prof, dev.type == "cuda")
           if (o.start_ns if o.launch_ns is None else o.launch_ns) >= lo]

    frames_a, frames_b = step_frames(spans_a), step_frames(spans_b)
    counters = counter_values(rec_a["counters"], frames_a)
    owner, by_launch, by_start = attribute(ops, spans_b)
    launches, device_ns = by_layer(ops, spans_b, owner)
    per_span: Dict[str, int] = defaultdict(int)
    for i in owner:
        per_span[spans_b[i].name if i >= 0 else OUTSIDE] += 1
    hi = max([sp.end_ns for sp in spans_b] + [o.end_ns for o in ops] + [lo])
    last = slice((win.passes - 1) * n, win.passes * n)
    same = [bool(torch.equal(poses[p], win.poses[last])) and
            bool(torch.equal(tracked[p], win.tracked[last])) for p in range(2)]
    out = SimpleNamespace(
        host_ms=host_ms(spans_a),
        frames=len(frames_a),
        tracked=tracked[0].tolist(),
        counters=counters,
        launches={k: v / max(len(frames_b), 1) for k, v in launches.items()},
        span_launches={k: v / max(len(frames_b), 1) for k, v in per_span.items()},
        device_ms={k: v * 1e-6 / max(len(frames_b), 1) for k, v in device_ns.items()},
        idle_gaps=idle_gaps(ops, spans_b, (lo, hi)),
        attribution={"launch": by_launch, "start": by_start},
        poses_equal=same,
    )
    res.program = out
    res.notes["program_idle_gaps"] = out.idle_gaps
    res.notes["program_host_ms"] = {k: [round(x, 4) for x in v] for k, v in out.host_ms.items()}
    res.notes["program_launches"] = {k: round(v, 2) for k, v in out.launches.items()}
    res.notes["program_span_launches"] = {k: round(v, 2) for k, v in out.span_launches.items()}
    res.notes["program_device_ms"] = {k: round(v, 4) for k, v in out.device_ms.items()}
    res.notes["program_counters"] = {k: round(sum(v) / len(v), 2) for k, v in counters.items()}
    res.notes["program_attribution"] = out.attribution
    res.notes["program_poses_equal"] = same
    return out
