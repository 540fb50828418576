"""The last line's schema, and the refusal to run without a card."""

import json
import os
import subprocess
import sys
from types import SimpleNamespace

from conftest import BENCH_DIR, ROOT
from harness.trace import DeviceOp, Span, TraceData

import run as runmod

KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def _res(attempted=300, failed=0):
    return SimpleNamespace(attempted=attempted, failed=failed)


def _device():
    return {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1,
            "memory_peak_bytes": 3 << 30, "power_limit_w": 700.0}


def test_untraced_line():
    correct, checks = runmod.checks_of({"a": 0.5, "b": 2.0}, {"a": 1.0, "b": 3.0})
    line = runmod.result_line(_res(), {"fusion_fps": {"value": 30.5, "unit": "frames/s"}},
                              _device(), None, checks, correct)
    assert list(line)[:5] == KEYS and list(line)[-1] == "checks"
    assert "breakdown" not in line and "busy_s" not in line["device"]
    assert line["correct"] is True
    assert line["checks"]["a"] == {"value": 0.5, "limit": 1.0}
    json.loads(json.dumps(line))


def test_traced_line_has_busy_window_and_breakdown():
    tr = TraceData([DeviceOp("k", 10, 30)], [Span("bench.step", 0, 40)], (0, 40))
    correct, checks = runmod.checks_of({"a": 0.5}, {"a": 1.0})
    line = runmod.result_line(_res(), {}, _device(), tr, checks, correct)
    assert line["device"]["busy_s"] == 20e-9 and line["device"]["window_s"] == 40e-9
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    assert len(line["breakdown"]["device_ops"]) <= 10
    assert list(line)[-1] == "checks"


def test_a_number_over_its_limit_or_missing_is_not_correct():
    assert runmod.checks_of({"a": 1.5}, {"a": 1.0})[0] is False
    assert runmod.checks_of({}, {"a": 1.0})[0] is False
    correct, checks = runmod.checks_of({"a": 0.0}, {"a": 1.0})
    assert runmod.result_line(_res(attempted=0), {}, _device(), None, checks, correct)[
        "correct"] is False


def test_refuses_without_a_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = subprocess.run([sys.executable, str(BENCH_DIR / "run.py"), "--workload",
                        "kinect-vga-512.orbit", "--seed", "1", "--seconds", "1", "--trace", "0"],
                       capture_output=True, text=True, cwd=ROOT, env=env, timeout=300)
    assert p.returncode != 0
    assert p.stdout.strip() == ""
