"""The building cell's comparison (``portbench/reference/building.py``)
on the CPU at a small size, the building's spans and counters, and the
driver's ``scan_building`` call against the command line's.

The house cut to the CPU: 3 rooms on floors of 2 and 1, each fused from
8 known poses (two sweeps of 4 at a pitch of +-0.6 rad, so the walls,
floor and ceiling are all seen) of 80 x 64 frames into a 128^3 volume
over the configuration's 3 m (the smallest volume on the kernel path the
cell runs: 64^3 does not tile into 128-voxel chunks, and would take the
dense path that neither the cell nor the reference runs). A whole run of
the benchmark's building traffic (``portbench/drivers/building.py``:
set-up, window, check) on the plain kernels: every room directory equals
the reference's, every room is fitted, and the assembly's numbers lie
within the cell's limits; the control (the same rooms fused on a bfloat16
volume) fails them.
"""

import json
import sys
import time
from pathlib import Path
from types import SimpleNamespace
from unittest import mock

import numpy as np
import pytest
import torch

BENCH_DIR = Path(__file__).resolve().parents[1] / "portbench"
if str(BENCH_DIR) not in sys.path:
    sys.path.append(str(BENCH_DIR))

from harness import building_trace, spec  # noqa: E402
from reference import building as ref_building  # noqa: E402

from housescan_tpu_torch.capture.replay import DepthStream, record_stream  # noqa: E402
from housescan_tpu_torch.cli.main import main as cli_main  # noqa: E402
from housescan_tpu_torch.config import Config  # noqa: E402
from housescan_tpu_torch.utils.metrics import GLOBAL_METRICS  # noqa: E402

CELL = "house-vga-512.building"
CAMERA = dict(width=80, height=64, fx=65.625, fy=65.625, cx=39.5, cy=31.5)
SEED = 2**31 + 2203
ASSEMBLY_SPANS = ("load", "fit", "arrange", "optimize", "xf")


def small_house():
    """The cell cut to 3 rooms on floors "2,1", 8 poses a room, 80 x 64
    frames, 128^3 voxels."""
    cell = spec.resolve(spec.load_benchmark(), CELL)
    cfg = json.loads(json.dumps(cell.config))
    cfg["camera"].update(CAMERA)
    cfg["volume"]["resolution"] = 128
    cfg["building"].update(rooms=3, floors=[2, 1])
    cfg["frames_per_room"] = 8
    sweeps = [dict(cell.traffic["sweeps"][0], frames=4, pitch_rad=0.6),
              dict(cell.traffic["sweeps"][1], frames=4, pitch_rad=-0.6)]
    traffic = dict(cell.traffic, rooms=3, floors="2,1", sweeps=sweeps)
    return cell._replace(config=cfg, traffic=traffic)


def _run(cell, volume_dtype=None):
    torch.set_num_threads(2)
    return spec.driver("building").run(cell, SEED, 0.05, False, time.time(),
                                       volume_dtype=volume_dtype, device="cpu")


@pytest.fixture(scope="module")
def house():
    cell = small_house()
    return cell, _run(cell)


def test_building_equals_the_reference(house):
    cell, res = house
    limits = cell.limits["numbers"]
    assert set(res.numbers) == set(ref_building.NUMBERS) == set(limits)
    rooms = {k: res.numbers[k] for k in ref_building.ROOM_NUMBERS}
    assert all(v == 0.0 for v in rooms.values()), res.numbers
    over = {k: res.numbers[k] for k in ref_building.ASSEMBLY_NUMBERS
            if not res.numbers[k] <= limits[k]}
    assert not over, res.numbers
    # a building worth comparing: every room replayed and fitted, the
    # floors' walls connected (1 on X, 1 from the ground floor up)
    assert res.failed == 0 and res.attempted == 24 * res.window.buildings
    assert res.notes["rooms_replayed"] == 3 and res.notes["unfitted"] == []
    assert sorted(ax for _, _, ax in res.window.got.connections) == [0, 1]


def test_the_control_fails_the_limits():
    cell = small_house()
    nums = _run(cell, "bfloat16").numbers
    over = [k for k, lim in cell.limits["numbers"].items() if nums[k] > lim]
    assert over, nums


def test_building_spans_nest_and_count(house):
    cell, res = house
    prog = res.prog
    GLOBAL_METRICS.drain()
    GLOBAL_METRICS.enable()
    try:
        scene, _, _ = prog.build(res.inputs, res.tmp / "spans", SimpleNamespace(hand=[], ends=[]),
                                 SimpleNamespace(mark=lambda: None))
    finally:
        GLOBAL_METRICS.disable()
    rec = GLOBAL_METRICS.drain()
    spans = rec["spans"]
    name_of = lambda i: spans[i].name if i >= 0 else None  # noqa: E731
    by = {}
    for sp in spans:
        by.setdefault(sp.name, []).append(sp)
    assert [sp.parent for sp in by["building"]] == [-1]
    assert len(by["building.room"]) == 3
    assert all(name_of(sp.parent) == "building" for sp in by["building.room"])
    assert [name_of(sp.parent) for sp in by["building.assembly"]] == ["building"]
    for part in ASSEMBLY_SPANS:
        assert [name_of(sp.parent) for sp in by[f"building.assembly.{part}"]] == \
            ["building.assembly"]
    # each room's steps and export inside its building.room
    assert len(by["step"]) == 24 and len(by["export"]) == 3
    assert {name_of(sp.parent) for sp in by["step"] + by["export"]} == {"building.room"}
    assert len({sp.frame for sp in spans}) == 1  # one building, one outermost span
    counts = {c.name: c.value for c in rec["counters"] if c.name.startswith("building.")}
    assert counts["building.wall_connections"] == len(scene.connected_walls) == 2
    assert counts["building.rooms"] == counts["building.fitted_rooms"] == 3
    assert 0 < counts["building.fit_iterations"] <= 2 * 2000


def test_building_metrics_read(house):
    cell, res = house
    ctx = SimpleNamespace(run=res, cell=cell, trace=None)
    got = {m["name"]: spec.metric_reader(m["name"]).read(ctx) for m in cell.per_layer}
    assert set(got) == {"room_host_ms.building", "assembly_host_ms.building",
                        "room_load_host_ms.building", "cuboid_fit_host_ms.building",
                        "fit_iterations.building", "wall_connections.building"}
    assert all(isinstance(v, float) and v > 0 for v in got.values()), got
    assert got["wall_connections.building"] == 2.0
    b = building_trace.building(ctx)
    assert got["cuboid_fit_host_ms.building"] < got["assembly_host_ms.building"]
    assert b.rooms == 3


def test_driver_calls_scan_building_as_the_command_line(tmp_path):
    """``scan-building --known-poses --floors 9,8,6`` on the house's
    streams hands ``scan_building`` what the driver hands it."""
    cell = spec.resolve(spec.load_benchmark(), CELL)
    drv = spec.driver("building")
    cfg = json.loads(json.dumps(cell.config))
    cfg["camera"].update(CAMERA)  # small frames: the call, not the scan, is compared
    inputs = drv.make_inputs(cfg, cell.traffic, SEED, torch.device("cpu"))
    prog = drv.Program(cell.config, cell.traffic, drv._scan.settings(cell.config),
                       torch.device("cpu"))
    paths = [record_stream(tmp_path / f"{r.name}.npz", r.frames, prog.intr, poses=inputs.poses)
             for r in inputs.rooms]
    b = prog.building
    calls = []
    with mock.patch("housescan_tpu_torch.kinfu.building.scan_building",
                    side_effect=lambda rooms, out, **kw: calls.append((rooms, kw)) or
                    (SimpleNamespace(), [], Path(out))), \
            mock.patch("housescan_tpu_torch.cli.main._save_scene"):
        cli_main(["--device", "cpu", "scan-building", str(tmp_path / "out"), *map(str, paths),
                  "--known-poses", "--floors", ",".join(map(str, b.floors)), "--gap", str(b.gap)])
    (cli_rooms, cli_kw), = calls
    ours = drv.room_scans([(r.name, DepthStream(r.frames, prog.intr, inputs.poses))
                           for r in inputs.rooms])
    assert [r.name for r in cli_rooms] == [r.name for r in ours]
    for a, o in zip(cli_rooms, ours):
        assert np.array_equal(a.init_pose, o.init_pose)
        assert np.array_equal(a.known_poses, o.known_poses)
        assert np.array_equal(np.stack(list(a.stream)), np.stack(list(o.stream)))
    assert (cli_kw.pop("config") or Config()) == prog.cfg
    assert cli_kw.pop("progress") is True and str(cli_kw.pop("device")) == "cpu"
    assert cli_kw == drv.building_call(b)
    assert b.floors == [9, 8, 6] and b.rooms == 23 and len(inputs.poses) == 32
