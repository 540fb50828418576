"""CPU tests of the benchmark: the plain kernels of the port at a tiny
size (a 128^3 volume, 160 x 120 frames). Run from the repository root:

    python -m pytest portbench/tests -q
"""

import copy
import sys
from pathlib import Path

import pytest

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent
for p in (str(ROOT), str(BENCH_DIR)):
    if p not in sys.path:
        sys.path.insert(0, p)

from harness import spec  # noqa: E402

TINY_CAMERA = dict(width=160, height=120, fx=131.25, fy=131.25, cx=79.5, cy=59.5)


def tiny(cell, frames=5):
    """``cell`` cut to the CPU: 128^3 voxels over the same 3 m, 160 x 120
    frames over the same field of view, ``frames`` frames a pass."""
    cfg = copy.deepcopy(cell.config)
    cfg["camera"].update(TINY_CAMERA)
    cfg["volume"]["resolution"] = 128
    traffic = dict(cell.traffic, frames=frames)
    return cell._replace(config=cfg, traffic=traffic)


@pytest.fixture(scope="session")
def bench():
    return spec.load_benchmark()


@pytest.fixture(scope="session")
def vga_cell(bench):
    return tiny(spec.resolve(bench, "kinect-vga-512.orbit"))
