"""The benchmark of the port (``housescan_tpu_torch``) on NVIDIA cards.

    python portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

runs one cell of ``BENCHMARK.json`` on the card(s) of this machine: the
cell's traffic driver makes the inputs from the seed and warms every
shape (set-up), measures for the given seconds, then holds what the
window produced to the plain reference. The last line of standard output
is one JSON object: ``correct``, ``attempted``, ``failed``, ``metrics``
(the cell's end-to-end metrics, or with ``--trace 1`` its per-layer
ones), ``device`` and, traced, ``breakdown``; its last key, ``checks``,
gives every number compared with its limit, and so do the last lines of
standard error. An earlier line gives the program's kernel launches and
plain-version calls in the window.

Without a CUDA card, or with fewer than the cell asks for, it prints no
result and exits with 2. Kernel build caches stay inside the checkout
(``build/``): the program's ``build/housescan_kernels/``, and
``TRITON_CACHE_DIR`` and ``TORCH_EXTENSIONS_DIR`` set here.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path
from types import SimpleNamespace


def _process_start() -> float:
    """Wall time at which this process started (Linux), else now."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        started = int(fields[19]) / os.sysconf("SC_CLK_TCK")
        return time.time() - (uptime - started)
    except (OSError, ValueError, IndexError):
        return time.time()


T_START = _process_start()
BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
for _p in (str(ROOT), str(BENCH_DIR)):
    if _p not in sys.path:
        sys.path.insert(0, _p)
os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton_cache")
os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")


def checks_of(numbers: dict, limits: dict):
    """(correct, {name: {value, limit}}): every number at or under its
    limit; a number the run did not produce fails."""
    out = {}
    ok = True
    for name, limit in limits.items():
        val = numbers.get(name)
        out[name] = {"value": val, "limit": limit}
        ok = ok and val is not None and val <= limit
    return ok, out


def result_line(res, metrics: dict, device: dict, trace, checks: dict, correct: bool) -> dict:
    """The result's JSON object: ``correct``, ``attempted``, ``failed``,
    ``metrics``, ``device``, then ``checks`` last. A traced run adds the
    device's busy and window seconds and the breakdown of device
    operations and idle gaps."""
    device = dict(device)
    if trace is not None:
        device["busy_s"] = trace.busy_s()
        device["window_s"] = trace.window_s
    line = {
        "correct": bool(correct and res.attempted > 0),
        "attempted": int(res.attempted),
        "failed": int(res.failed),
        "metrics": metrics,
        "device": device,
    }
    if trace is not None:
        line["breakdown"] = {"device_ops": trace.top_ops(10), "idle_gaps": trace.idle_by_span(10)}
    line["checks"] = checks
    return line


def read_metrics(metrics, ctx, spec):
    out = {}
    for m in metrics:
        val = spec.metric_reader(m["name"]).read(ctx)
        if val is not None:
            out[m["name"]] = {"value": float(val), "unit": m["unit"]}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from harness import spec
    from harness.peaks import power_limit_w

    cell = spec.resolve(spec.load_benchmark(), args.workload)
    import torch

    torch.set_num_threads(1)  # one process, few threads: the card does the work
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"portbench: {args.workload} needs {cell.chips} CUDA card(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    driver = spec.driver(cell.traffic["kind"])
    res = driver.run(cell, args.seed, args.seconds, bool(args.trace), T_START)
    trace = res.window.tracer.read() if args.trace else None
    ctx = SimpleNamespace(run=res, cell=cell, trace=trace)
    metrics = read_metrics(cell.per_layer if args.trace else cell.end_to_end, ctx, spec)
    correct, checks = checks_of(res.numbers, cell.limits["numbers"])
    device = {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": cell.chips,
        "memory_peak_bytes": int(res.memory_peak_bytes),
        "power_limit_w": power_limit_w(),
    }
    launches, plain = res.window.counts
    print(json.dumps({"window_launch_counts": launches, "window_plain_counts": plain,
                      **res.notes}))
    line = result_line(res, metrics, device, trace, checks, correct)
    for name, c in checks.items():
        print(f"check {name} {c['value']} <= {c['limit']}", file=sys.stderr)
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
