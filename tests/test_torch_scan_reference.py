"""The scan cells' comparison (``portbench/reference/scan.py``) on the
CPU at a small size, and the volume's flat offsets past 2^31.

Each scan cell's configuration cut to 128^3 voxels over its own side (3
m and 6 m: a smaller cube holds no wall of either room), 80 x 64 frames
over the same field of view (the kernel path takes heights that are
multiples of 8) and 5 frames a scan: a whole run of the benchmark's scan
traffic (``portbench/drivers/scan.py``: set-up, window, check) on the
plain kernels, whose room directory (poses, clouds, planes, hulls, mesh)
equals the plain reference's on every number, while the control (the
same scan on a bfloat16 volume) fails the cell's limits.

The offsets: at R = 1024 the float32 (2, R, R, R) volume holds 2^31
cells, one more than int32 counts; its weight plane's byte offsets pass
2^32. The chunk cells the work list names
(``ops/tsdf_stream.chunk_cells``) index it in int64 and land where the
kernels' 64-bit formula (``csrc/tsdf_stream.cu``, ``csrc/tsdf_free.cu``)
puts them; the strides are a meta tensor's, so nothing is allocated.
"""

import copy
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

BENCH_DIR = Path(__file__).resolve().parents[1] / "portbench"
if str(BENCH_DIR) not in sys.path:
    sys.path.append(str(BENCH_DIR))

from harness import spec  # noqa: E402
from reference import scan as ref_scan  # noqa: E402

from housescan_tpu_torch.kinfu.camera import Intrinsics  # noqa: E402
from housescan_tpu_torch.ops.chunk_select import build_worklist  # noqa: E402
from housescan_tpu_torch.ops.tsdf_stream import CHUNK_Z, chunk_cells  # noqa: E402

CELLS = ("kinect-vga-512.scan", "room-vga-1024.room-scan")
CAMERA = dict(width=80, height=64, fx=65.625, fy=65.625, cx=39.5, cy=31.5)
SEED = 2**31 + 1017


def small(cell_name: str):
    cell = spec.resolve(spec.load_benchmark(), cell_name)
    cfg = copy.deepcopy(cell.config)
    cfg["camera"].update(CAMERA)
    cfg["volume"]["resolution"] = 128
    return cell._replace(config=cfg, traffic=dict(cell.traffic, frames=5))


def _run(cell, volume_dtype=None):
    torch.set_num_threads(2)
    drv = spec.driver(cell.traffic["kind"])
    return drv.run(cell, SEED, 0.05, False, time.time(), volume_dtype=volume_dtype,
                   device="cpu")


@pytest.mark.parametrize("cell_name", CELLS)
def test_room_directory_equals_the_reference(cell_name):
    cell = small(cell_name)
    res = _run(cell)
    assert set(res.numbers) == set(ref_scan.NUMBERS) == set(cell.limits["numbers"])
    assert all(v == 0.0 for v in res.numbers.values()), res.numbers
    room = ref_scan.read_room(res.window.room)
    # a room worth comparing: every frame tracked, a cloud, planes, hulls
    # and a mesh
    assert res.failed == 0 and res.attempted == 5 * res.window.scans
    assert len(room.cloud) > 1000 and len(room.planes) >= 2 and len(room.triangles) > 1000
    assert all(len(h) >= 3 for h in room.hulls)
    assert room.poses.shape == (5, 4, 4)


def test_the_control_fails_the_limits():
    cell = small(CELLS[0])
    nums = _run(cell, "bfloat16").numbers
    over = [k for k, lim in cell.limits["numbers"].items() if nums[k] > lim]
    assert over, nums


def test_volume_offsets_past_2_to_the_31():
    r = 1024
    meta = torch.empty((2, r, r, r), dtype=torch.float32, device="meta")
    weight = meta[1]
    # a frame of the +x half of the room seen from the volume's centre
    intr = Intrinsics(160, 120, 131.25, 131.25, 79.5, 59.5)
    pose = torch.tensor([[0.0, 0.0, -1.0, 0.0], [0.0, 1.0, 0.0, 0.0], [1.0, 0.0, 0.0, 0.0],
                         [0.0, 0.0, 0.0, 1.0]])
    depth = torch.full((120, 160), 2.5)
    wl = build_worklist(depth, pose, intr, r, torch.tensor(6.0 / r), torch.full((3,), -3.0),
                        torch.tensor(0.03))
    rows = wl.desc[: int(wl.count[0])].long()
    ci, cj, ck = rows[:, 0], rows[:, 1], rows[:, 2]
    assert len(rows) > 100 and int(ci.min()) >= r // 16  # every listed chunk lies past x = 512
    ids = (ci * (r // 8) + cj) * (r // CHUNK_Z) + ck
    assert bool((ids[1:] > ids[:-1]).all())  # raster order, each chunk once
    xi, yi, zi = chunk_cells(ci, cj, ck)
    assert xi.dtype == yi.dtype == zi.dtype == torch.int64
    flat = weight.storage_offset() + xi * weight.stride(0) + yi * weight.stride(1) + zi
    # the weight plane: element offsets from 2^30, byte offsets past 2^32
    assert flat.dtype == torch.int64 and int(flat.min()) >= r**3 and 4 * int(flat.max()) > 2**32
    # the kernels' size_t formula: plane + ((x * ny + y) * nz + z)
    x, y, z = 8 * ci[:, None] + torch.arange(8), 8 * cj[:, None] + 7, CHUNK_Z * ck[:, None] + 127
    kernel = r**3 + (x * r + y) * r + z
    assert torch.equal(kernel, flat[:, :, 7, 127])
    # the last cell is int32's largest value; the count of cells, 2^31,
    # is past it
    last = weight.storage_offset() + (r - 1) * (weight.stride(0) + weight.stride(1) + 1)
    assert last == 2 * r**3 - 1 == meta.numel() - 1 == 2**31 - 1
    assert np.array([meta.numel()], np.int64).astype(np.int32)[0] < 0
