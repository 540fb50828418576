"""Structured metrics and timing: a copy of
``housescan_tpu/utils/metrics.py``.

Named metrics with JSONL emission and counters, gauges and timers
(``Metrics``, ``GLOBAL_METRICS``); the TSDF occupancy of a port volume;
``device_trace`` on ``torch.profiler`` in place of the reference's
``jax.profiler``.
"""

from __future__ import annotations

import json
import time
from collections import defaultdict
from contextlib import contextmanager
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional, Union

import torch


@dataclass
class Metrics:
    values: Dict[str, List[float]] = field(default_factory=lambda: defaultdict(list))
    sink_path: Optional[Path] = None

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


GLOBAL_METRICS = Metrics()


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
