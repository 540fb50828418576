"""The export's spans read a scan at a time (``harness/scan_trace.py``),
and one traced scan run on the CPU whose seven readers all give a
number."""

import copy
import time
from types import SimpleNamespace

import pytest
import torch

import run as runmod
from harness import program_trace as pt
from harness import scan_trace as st
from harness import spec

from housescan_tpu_torch.utils.metrics import SpanRecord

NEW = ("export_host_ms.scan", "surface_host_ms.scan", "ransac_host_ms.scan", "mesh_host_ms.scan",
       "surface_points.scan", "mesh_triangles.scan", "surface_roofline.scan")


def _spans():
    # two scans: a step frame, then an export frame with its children
    return [
        SpanRecord("step", -1, 1, 0, 10),
        SpanRecord("export", -1, 2, 20, 100),
        SpanRecord("export.surface", 1, 2, 22, 30),
        SpanRecord("export.writes", 1, 2, 30, 34),
        SpanRecord("export.writes", 1, 2, 60, 70),
        SpanRecord("step", -1, 3, 200, 210),
        SpanRecord("export", -1, 4, 220, 260),
        SpanRecord("export.surface", 6, 4, 222, 226),
    ]


def test_host_ms_sums_within_each_export():
    got = st.per_scan_host_ms(_spans())
    want = {"export": [80e-6, 40e-6], "export.surface": [8e-6, 4e-6], "export.writes": [14e-6, 0.0]}
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k] == pytest.approx(v)


def test_device_ms_counts_children_in_their_parents():
    ops = [pt.Op("a", 500, 520, 23), pt.Op("b", 600, 610, 65), pt.Op("c", 700, 705, 5),
           pt.Op("d", 800, 830, 223)]
    got = st.device_ms_by_span(ops, _spans(), 2)
    assert got == pytest.approx({"export": 60e-6 / 2, "export.surface": 50e-6 / 2,
                                 "export.writes": 10e-6 / 2, "step": 5e-6 / 2})


def test_a_traced_cpu_scan_reads_every_new_metric(bench):
    cell = spec.resolve(bench, "kinect-vga-512.scan")
    cfg = copy.deepcopy(cell.config)
    cfg["camera"].update(dict(width=80, height=64, fx=65.625, fy=65.625, cx=39.5, cy=31.5))
    cfg["volume"]["resolution"] = 128
    cell = cell._replace(config=cfg, traffic=dict(cell.traffic, frames=4))
    torch.set_num_threads(4)
    res = spec.driver("scan").run(cell, 2**31 + 99, 0.05, True, time.time(), device="cpu")
    ctx = SimpleNamespace(run=res, cell=cell, trace=res.window.tracer.read())
    got = runmod.read_metrics(cell.per_layer, ctx, spec)
    assert set(got) == set(NEW)
    assert got["surface_points.scan"]["value"] > 1000
    assert got["mesh_triangles.scan"]["value"] > 1000
    assert 0 < got["surface_roofline.scan"]["value"] <= 100
    assert got["export_host_ms.scan"]["value"] >= got["mesh_host_ms.scan"]["value"] > 0
    assert all(v == 0.0 for k, v in res.numbers.items() if not k.startswith("pose")), res.numbers
