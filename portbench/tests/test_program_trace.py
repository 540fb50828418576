"""The program's spans read by layer (``harness/program_trace.py``): self
time, operations placed in the innermost span by their launch or their
start, idle gaps by the span the host was in; and one traced orbit run on
the CPU, whose new readers all give a number while the old ones read as
before."""

import time
from types import SimpleNamespace

import pytest
import torch

import run as runmod
from harness import program_trace as pt
from harness import spec

from housescan_tpu_torch.utils.metrics import SpanRecord

NEW = ("track_host_ms.fusion", "integrate_host_ms.fusion", "raycast_host_ms.fusion",
       "track_launches.fusion", "integrate_launches.fusion", "raycast_launches.fusion",
       "raycast_device_ms.fusion", "listed_chunks.fusion", "icp_iterations.fusion")


def _spans():
    # frame 1: init [0, 10); frame 2: step [20, 100) with track [22, 50)
    # (track.icp [30, 45)) and raycast [60, 90)
    return [
        SpanRecord("init", -1, 1, 0, 10),
        SpanRecord("step", -1, 2, 20, 100),
        SpanRecord("track", 1, 2, 22, 50),
        SpanRecord("track.icp", 2, 2, 30, 45),
        SpanRecord("raycast", 1, 2, 60, 90),
    ]


def test_self_time_is_the_duration_less_the_children():
    assert pt.self_ns(_spans()) == [10, 80 - 28 - 30, 28 - 15, 15, 30]
    ms = pt.host_ms(_spans())
    assert ms["step"] == pytest.approx([80e-6, 22e-6])
    assert ms["track"] == pytest.approx([28e-6, 13e-6])
    assert "init" not in ms  # not part of a step frame


def test_innermost_span_at_a_time():
    got = pt.innermost(_spans(), [5, 15, 21, 29, 30, 44, 45, 55, 89, 90, 100])
    assert got == [0, -1, 1, 2, 3, 3, 2, 1, 4, 1, -1]


def test_operations_go_to_their_launch_else_their_start():
    ops = [
        pt.Op("k_init", 11, 14, 3),  # launched in init, ran after it
        pt.Op("k_icp", 46, 50, 31),  # launched in track.icp, ran in track
        pt.Op("k_ray", 62, 70, None),  # no launch record: where it started
        pt.Op("k_glue", 95, 99, 92),  # the step's own
        pt.Op("copy", 101, 105, None),  # after every span
    ]
    owner, by_launch, by_start = pt.attribute(ops, _spans())
    assert owner == [0, 3, 4, 1, -1]
    assert (by_launch, by_start) == (3, 2)
    n, ns = pt.by_layer(ops, _spans(), owner)
    assert n == {"init": 1, "track": 1, "raycast": 1, "step": 1, "outside": 1}
    assert ns["raycast"] == 8 and ns["track"] == 4


def test_idle_gaps_by_the_innermost_span_at_their_start():
    ops = [pt.Op("a", 5, 12, 1), pt.Op("b", 35, 40, 31), pt.Op("c", 62, 95, 61)]
    got = dict(pt.idle_gaps(ops, _spans(), (0, 100)))
    # gaps [0,5) init, [12,35) outside (12-20) begins outside, [40,62)
    # track.icp, [95,100) step
    assert got == pytest.approx({"init": 5e-9, "outside": 23e-9, "track.icp": 22e-9,
                                 "step": 5e-9})


def test_counters_by_frame():
    C = SimpleNamespace
    got = pt.counter_values([C(name="a", frame=2, value=3), C(name="a", frame=4, value=5),
                             C(name="b", frame=4, value=1.5), C(name="a", frame=9, value=7)],
                            [2, 4])
    assert got == {"a": [3.0, 5.0], "b": [0.0, 1.5]}


def test_a_program_without_spans_gives_nothing(monkeypatch):
    import housescan_tpu_torch.utils.metrics as m

    class Old:
        pass

    monkeypatch.setattr(m, "GLOBAL_METRICS", Old())
    res = SimpleNamespace(window=SimpleNamespace(state=object()), notes={})
    ctx = SimpleNamespace(run=res, cell=None, trace=None)
    assert pt.passes(ctx) is None
    for name in NEW:
        assert spec.metric_reader(name).read(ctx) is None
    assert "program_idle_gaps" not in res.notes


def test_traced_orbit_run_reads_every_new_metric(vga_cell):
    """A whole traced run on the CPU; the two extra passes run when the
    first new reader asks, after every old one has read."""
    torch.set_num_threads(4)
    drv = spec.driver("orbit")
    res = drv.run(vga_cell, 2**31 + 91, 0.1, True, time.time(), device="cpu")
    ctx = SimpleNamespace(run=res, cell=vga_cell, trace=res.window.tracer.read())
    old = [m for m in vga_cell.per_layer if m["name"] not in NEW]
    new = [m for m in vga_cell.per_layer if m["name"] in NEW]
    assert sorted(m["name"] for m in new) == sorted(NEW)
    before = runmod.read_metrics(old, ctx, spec)
    got = runmod.read_metrics(new, ctx, spec)
    assert sorted(got) == sorted(NEW), got
    assert runmod.read_metrics(old, ctx, spec) == before
    assert res.program.poses_equal == [True, True]
    assert all(res.program.host_ms[k][0] > 0 for k in ("step", "track", "integrate", "raycast"))
    n_levels = int(vga_cell.config["icp"]["levels"])
    assert 3 <= got["icp_iterations.fusion"]["value"] <= sum(vga_cell.config["icp"]["iterations"])
    assert n_levels == 3 and got["listed_chunks.fusion"]["value"] > 0
    gaps = res.notes["program_idle_gaps"]
    assert 0 < len(gaps) <= 10 and all(s >= 0 for _, s in gaps)
    assert res.notes["program_attribution"]["start"] == 0  # the CPU's ops run as launched
