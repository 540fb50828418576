"""Resolve a cell of ``BENCHMARK.json`` to the files that define it.

Everything is found by name, so a later change adds a cell, a
configuration, a traffic mix or a metric as new files and new entries:

  * ``configs/<config>.json``: the configuration (sizes and settings);
  * ``traffic/<traffic>.json``: the traffic mix; its ``kind`` names the
    driver, ``drivers/<kind>.py``, that runs it;
  * ``limits/<cell>.json``: the limits of the numbers that decide
    ``correct`` in that cell;
  * ``metrics/<metric>.py``: the reader of one metric, with a function
    ``read(ctx)`` that returns a number or None (nothing to read).
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import List, NamedTuple

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent


class Cell(NamedTuple):
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: List[dict]
    per_layer: List[dict]


def load_benchmark(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def _json(path: Path) -> dict:
    if not path.is_file():
        raise FileNotFoundError(f"{path} is missing")
    return json.loads(path.read_text())


def reports(metric: dict, cell: str) -> bool:
    """Whether ``cell`` reports ``metric``: a metric without a
    ``workloads`` key is reported in every cell."""
    return "workloads" not in metric or cell in metric["workloads"]


def resolve(bench: dict, cell_name: str, bench_dir: Path = BENCH_DIR) -> Cell:
    cells = {w["name"]: w for w in bench["workloads"]}
    if cell_name not in cells:
        raise KeyError(f"no cell {cell_name!r} in BENCHMARK.json (cells: {sorted(cells)})")
    w = cells[cell_name]
    configs = {c["name"]: c for c in bench["configs"]}
    cfg_entry = configs[w["config"]]
    config = _json(bench_dir.parent / cfg_entry["file"])
    traffic = _json(bench_dir / "traffic" / f"{w['traffic']}.json")
    limits = _json(bench_dir / "limits" / f"{cell_name}.json")
    return Cell(
        name=cell_name,
        chips=int(w["chips"]),
        config=config,
        traffic=traffic,
        limits=limits,
        end_to_end=[m for m in bench["end_to_end"] if reports(m, cell_name)],
        per_layer=[m for m in bench["per_layer"] if reports(m, cell_name)],
    )


def load_module(path: Path, name: str) -> ModuleType:
    """Import the Python file ``path`` under the module name ``name``
    (metric names hold dots, so they are loaded by path)."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise ImportError(f"cannot load {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_reader(metric_name: str, bench_dir: Path = BENCH_DIR) -> ModuleType:
    path = bench_dir / "metrics" / f"{metric_name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"metric {metric_name!r} has no reader {path}")
    return load_module(path, "portbench_metric_" + metric_name.replace(".", "_").replace("-", "_"))


def driver(kind: str, bench_dir: Path = BENCH_DIR) -> ModuleType:
    path = bench_dir / "drivers" / f"{kind}.py"
    if not path.is_file():
        raise FileNotFoundError(f"traffic kind {kind!r} has no driver {path}")
    return load_module(path, "portbench_driver_" + kind.replace("-", "_"))
