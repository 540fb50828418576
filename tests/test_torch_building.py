"""The port's building scan (``housescan_tpu_torch/kinfu/building.py``).

Twins of ``tests/test_building.py``'s tests that are not slow, on the
CPU (the room stage's scenes and the mesh's shards there too), with
their bounds, but three: the tracked two-room building (1,084 tracked
frames), the 8-room grid and the 3-floor building (8 and 6 rooms of 24
frames at 128^3) take the port's plain versions 1-2 s a frame and ~12 s
of RANSAC a room on the CPU, 10-20 minutes each, so their twins run on
the card (``tests/test_torch_gpu.py``); then the building checkpoint written by each package
resumed by the other (the schema is the reference's), and the Cantor
slot orders against the reference's.
"""

import json
import unittest.mock as mock

import numpy as np
import pytest
import torch

from housescan_tpu_torch.capture.replay import DepthStream
from housescan_tpu_torch.config import Config, RansacConfig, TsdfConfig
from housescan_tpu_torch.kinfu.building import (
    RoomScan,
    cantor_slots,
    cantor_slots_3d,
    scan_building,
)
from housescan_tpu_torch.kinfu.camera import Intrinsics
from housescan_tpu_torch.kinfu.synthetic import furnished_room, orbit_poses, render_depth_stream
from housescan_tpu_torch.parallel import make_mesh

INTR = Intrinsics(width=160, height=120, fx=131.25, fy=131.25, cx=79.5, cy=59.5)
CFG = Config(
    tsdf=TsdfConfig(resolution=128, size_m=3.2, trunc_dist=0.06),
    ransac=RansacConfig(min_inlier_fraction=0.02),
)
SMALL = Config(
    tsdf=TsdfConfig(resolution=64, size_m=3.2, trunc_dist=0.1),
    ransac=RansacConfig(min_inlier_fraction=0.02),
)


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _frames(poses, seed):
    half = np.array([1.3, 1.1, 1.3], np.float32)
    _, boxes = furnished_room()
    return render_depth_stream(INTR, poses, half, boxes=boxes, seed=seed, device="cpu").numpy()


def _room_scans(n_rooms=2, n_frames=6, seed0=0):
    rooms = []
    for ri in range(n_rooms):
        poses = orbit_poses(n_frames, radius=0.25, yaw_range=0.4, pitch=0.3, seed=seed0 + ri)
        rooms.append(RoomScan(name=f"room{ri}",
                              stream=DepthStream(frames=_frames(poses, seed0 + ri), intrinsics=INTR),
                              init_pose=poses[0]))
    return rooms


def _sweep_rooms(n):
    """Full-coverage known-pose sweeps (walls up and down, floor and
    ceiling passes, 6 poses each): every room shows all six faces."""
    rooms = []
    for ri in range(n):
        sweeps = [orbit_poses(6, radius=0.25, yaw_range=6.283, pitch=p, seed=ri) for p in (0.35, -0.35)]
        sweeps.append(orbit_poses(6, radius=0.7, height=-0.6, yaw_range=6.283, pitch=-1.2, seed=ri))
        sweeps.append(orbit_poses(6, radius=0.7, height=0.6, yaw_range=6.283, pitch=1.2, seed=ri))
        poses = np.concatenate(sweeps)
        rooms.append(RoomScan(name=f"room{ri}",
                              stream=DepthStream(frames=_frames(poses, ri), intrinsics=INTR),
                              init_pose=poses[0], known_poses=poses))
    return rooms


def _cpu_mesh():
    return make_mesh(8, devices=["cpu"] * 8)


class _PoisonStream:
    """A stream that records (and fails) if anyone iterates it."""

    def __init__(self, calls, like):
        self.calls = calls
        self.intrinsics = like.intrinsics
        self._n = len(like)

    def __len__(self):
        return self._n

    def __iter__(self):
        self.calls.append("iterated")
        raise AssertionError("resumed building scan iterated a finished room")


class _SimulatedCrash(RuntimeError):
    pass


class _DyingStream:
    def __init__(self, like, die_at):
        self.intrinsics = like.intrinsics
        self._frames = list(like)
        self._die_at = die_at

    def __len__(self):
        return len(self._frames)

    def __iter__(self):
        for k, f in enumerate(self._frames):
            if k == self._die_at:
                raise _SimulatedCrash(f"killed at frame {k}")
            yield f


class TestScanBuilding:
    def test_two_room_building_end_to_end(self, tmp_path):
        rooms = _room_scans(2)
        scene, fitted, out = scan_building(rooms, tmp_path / "bld", config=CFG, gap=0.1,
                                           device="cpu")
        assert len(scene.rooms) == 2 and len(fitted) == 2
        for r in rooms:
            for f in ("cloud_downsampled.pcd", "planes.txt", "trajectory.npz"):
                assert (out / r.name / f).exists()
        done = json.loads((out / "building_checkpoint.json").read_text())
        assert done["rooms_done"] == ["room0", "room1"]
        assert len(sorted((out / "xf").glob("*.xf"))) == 2
        for r in fitted:
            assert len(r.planes) >= 2

    def test_resume_skips_finished_rooms(self, tmp_path):
        rooms = _room_scans(2)
        out = tmp_path / "bld"
        scan_building(rooms[:1], out, config=CFG, device="cpu")
        assert json.loads((out / "building_checkpoint.json").read_text())["rooms_done"] == ["room0"]
        calls = []
        bad = RoomScan(name="room0", stream=_PoisonStream(calls, rooms[0].stream))
        scene, _, _ = scan_building([bad, rooms[1]], out, config=CFG, resume=True, device="cpu")
        assert not calls, "finished room was rescanned on resume"
        assert len(scene.rooms) == 2

    def test_sharded_room_path_on_cpu_mesh(self, tmp_path):
        rooms = _room_scans(1, n_frames=4)
        scene, fitted, out = scan_building(rooms, tmp_path / "bld", config=SMALL, mesh=_cpu_mesh(),
                                           sharded_min_resolution=64, device="cpu")
        d = out / "room0"
        assert (d / "cloud_bin.pcd").exists() and (d / "trajectory.npz").exists()
        traj = np.load(d / "trajectory.npz")["poses"]
        assert traj.shape == (4, 4, 4) and np.isfinite(traj).all()


class TestGridBuilding:
    def test_cantor_slots_order(self):
        assert cantor_slots(6) == [(0, 0), (1, 0), (0, 1), (2, 0), (1, 1), (0, 2)]
        assert len(cantor_slots(23)) == 23

class TestThreeFloorBuilding:
    def test_cantor_slots_3d(self):
        assert cantor_slots_3d(6, 3) == [(0, 0, 0), (1, 0, 0), (0, 1, 0), (1, 1, 0),
                                         (0, 2, 0), (1, 2, 0)]
        assert len(cantor_slots_3d(23, 3)) == 23

class TestShardedMidRoomResume:
    def test_kill_and_resume_mid_sharded_room(self, tmp_path):
        """A building run killed mid sharded room resumes from the scan
        checkpoint: only the frames after it are fused again."""
        import housescan_tpu_torch.parallel.sharded as sharded_mod

        mesh = _cpu_mesh()
        rooms = _room_scans(1, n_frames=6)
        out = tmp_path / "bld"
        dying = RoomScan(name="room0", stream=_DyingStream(rooms[0].stream, die_at=4),
                         init_pose=rooms[0].init_pose)
        with pytest.raises(_SimulatedCrash):
            scan_building([dying], out, config=SMALL, mesh=mesh, sharded_min_resolution=64,
                          checkpoint_every=2, device="cpu")
        with np.load(out / "room0" / "scan_checkpoint.npz") as z:
            assert json.loads(str(z["manifest"]))["frame_index"] == 4
        calls = []
        real_make = sharded_mod.make_sharded_step

        def counted_make(*a, **kw):
            step = real_make(*a, **kw)

            def stepped(state, frame, **kw2):
                calls.append(1)
                return step(state, frame, **kw2)

            return stepped

        with mock.patch.object(sharded_mod, "make_sharded_step", counted_make):
            scene, _, _ = scan_building(rooms, out, config=SMALL, mesh=mesh,
                                        sharded_min_resolution=64, checkpoint_every=2,
                                        resume=True, device="cpu")
        assert len(calls) == 2, f"resume fused {len(calls)} frames, wanted 2"
        traj = np.load(out / "room0" / "trajectory.npz")["poses"]
        assert traj.shape == (6, 4, 4) and np.isfinite(traj).all()
        assert len(scene.rooms) == 1


class TestAcrossPackages:
    """The building checkpoint's schema is the reference's: a building
    begun by either package resumes in the other without rescanning the
    finished room, and the Cantor orders are the reference's."""

    def test_cantor_orders_equal_reference(self):
        pytest.importorskip("jax")
        from housescan_tpu.kinfu.building import cantor_slots as j_slots
        from housescan_tpu.kinfu.building import cantor_slots_3d as j_slots_3d

        for n in (1, 6, 8, 23, 40):
            assert cantor_slots(n) == j_slots(n)
        for n, floors in ((6, 3), (23, 3), (23, [9, 8, 6]), (5, [0, 2, 3]), (7, 2)):
            assert cantor_slots_3d(n, floors) == j_slots_3d(n, floors)
        with pytest.raises(ValueError):
            cantor_slots_3d(10, [2, 3])

    @pytest.mark.parametrize("first", ["reference", "port"])
    def test_building_resumes_across_packages(self, tmp_path, first):
        pytest.importorskip("jax")
        from housescan_tpu.capture.replay import DepthStream as JDepthStream
        from housescan_tpu.kinfu.building import RoomScan as JRoomScan
        from housescan_tpu.kinfu.building import scan_building as j_scan_building
        from housescan_tpu.kinfu.camera import Intrinsics as JIntrinsics
        from housescan_tpu.config import Config as JConfig
        from housescan_tpu.config import RansacConfig as JRansacConfig
        from housescan_tpu.config import TsdfConfig as JTsdfConfig

        jintr = JIntrinsics(*INTR)
        jcfg = JConfig(tsdf=JTsdfConfig(resolution=64, size_m=3.2, trunc_dist=0.1),
                       ransac=JRansacConfig(min_inlier_fraction=0.02))
        rooms = _room_scans(2, n_frames=4)
        j_rooms = [JRoomScan(name=r.name, stream=JDepthStream(frames=r.stream.frames,
                                                              intrinsics=jintr),
                             init_pose=r.init_pose) for r in rooms]
        out = tmp_path / "bld"
        calls = []
        if first == "reference":
            j_scan_building(j_rooms[:1], out, config=jcfg)
            bad = RoomScan(name="room0", stream=_PoisonStream(calls, rooms[0].stream))
            scene, _, _ = scan_building([bad, rooms[1]], out, config=SMALL, resume=True,
                                        device="cpu")
        else:
            scan_building(rooms[:1], out, config=SMALL, device="cpu")
            bad = JRoomScan(name="room0", stream=_PoisonStream(calls, j_rooms[0].stream))
            scene, _, _ = j_scan_building([bad, j_rooms[1]], out, config=jcfg, resume=True)
        assert not calls, "the finished room was rescanned"
        assert len(scene.rooms) == 2
        bc = json.loads((out / "building_checkpoint.json").read_text())
        assert bc["rooms_done"] == ["room0", "room1"]
        assert {"fit_rmse", "n_wall_connections", "optimize"} <= set(bc)
