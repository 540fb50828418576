"""Cells, configurations, traffic, limits and metrics resolve by name,
and a new cell needs only new files and new entries."""

import hashlib
import json
import shutil

import pytest

from conftest import BENCH_DIR
from harness import spec


def test_every_cell_resolves(bench):
    for w in bench["workloads"]:
        cell = spec.resolve(bench, w["name"])
        assert cell.config["name"] == w["config"]
        assert cell.chips == w["chips"] == 1
        spec.driver(cell.traffic["kind"])
        assert cell.limits["numbers"]
        names = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in names and len(names) >= 2
        assert cell.per_layer


def test_every_metric_has_a_reader(bench):
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert callable(spec.metric_reader(m["name"]).read)


def test_every_config_lists_its_source_and_cuts(bench):
    for c in bench["configs"]:
        cfg = json.loads((BENCH_DIR.parent / c["file"]).read_text())
        assert cfg["name"] == c["name"]
        assert cfg["reduced"] == c["reduced"]
        assert cfg["source"] and "assumed" in cfg


def test_an_unknown_cell_is_refused(bench):
    with pytest.raises(KeyError):
        spec.resolve(bench, "no-such.cell")


def _digest(root):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file() and "__pycache__" not in p.parts}


def test_a_new_cell_needs_only_new_files(bench, tmp_path):
    """A dummy cell with its own configuration, traffic, limits and
    per-layer metric: added as files and entries, resolved and read, and
    no file that was there before changes."""
    root = tmp_path / "repo"
    bench_dir = root / "portbench"
    shutil.copytree(BENCH_DIR, bench_dir, ignore=shutil.ignore_patterns("__pycache__"))
    before = _digest(bench_dir)

    cfg = json.loads((bench_dir / "configs" / "kinect-vga-512.json").read_text())
    cfg["name"] = "dummy-cfg"
    (bench_dir / "configs" / "dummy-cfg.json").write_text(json.dumps(cfg))
    (bench_dir / "traffic" / "dummy-mix.json").write_text(
        json.dumps({"kind": "orbit", "world": "furnished_room", "frames": 3, "radius_m": 0.1,
                    "yaw_range_rad": 0.1, "pitch_rad": 0.0}))
    (bench_dir / "limits" / "dummy-cfg.dummy-mix.json").write_text(
        json.dumps({"numbers": {"pose_gap_mm": 1.0}}))
    (bench_dir / "metrics" / "dummy_count.mix.py").write_text(
        "def read(ctx):\n    return 42.0\n")
    new = json.loads(json.dumps(bench))
    new["configs"].append({"name": "dummy-cfg", "source": "https://example.org",
                           "file": "portbench/configs/dummy-cfg.json", "reduced": [],
                           "why": "a test"})
    new["workloads"].append({"name": "dummy-cfg.dummy-mix", "config": "dummy-cfg",
                             "traffic": "dummy-mix", "chips": 1, "why": "a test"})
    new["per_layer"].append({"name": "dummy_count.mix", "unit": "count", "better": "lower",
                             "source": "program_counter", "layer": "test",
                             "moves": "fusion_fps", "workloads": ["dummy-cfg.dummy-mix"]})

    cell = spec.resolve(new, "dummy-cfg.dummy-mix", bench_dir)
    assert cell.traffic["frames"] == 3 and cell.config["name"] == "dummy-cfg"
    assert [m["name"] for m in cell.per_layer] == ["dummy_count.mix"]
    assert spec.metric_reader("dummy_count.mix", bench_dir).read(None) == 42.0
    assert spec.driver(cell.traffic["kind"], bench_dir).run
    after = _digest(bench_dir)
    assert {k: v for k, v in after.items() if k in before} == before
