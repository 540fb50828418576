"""Twins of ``tests/test_rooms.py`` on the port's room stage (every scene
on the CPU), ending in the twin of ``TestEndToEndSlice``, with the
reference's bounds; then parity with the reference's room stage.

Parity: the same room directory (the port's ``make_synthetic_room_dir``,
the reference's, and a directory the port's scan wrote) goes to both
packages' ``load_room``; the arrays loaded must be equal (colours are
drawn unseeded in both, so they are not compared). Then both run the same
steps: corners within 1e-4 m, cuboid rmse within 1e-5, fitted corners
and planes within 1e-4, optimised positions within 1e-4 m, .xf matrices
within 1e-5, placed points within 1e-4 m.
"""

import inspect

import numpy as np
import pytest
import torch

from housescan_tpu_torch.geometry.transform import apply_proj4, axis_angle_mat
from housescan_tpu_torch.io.pcd import load_pcd
from housescan_tpu_torch.io.xf import load_xf
from housescan_tpu_torch.rooms import (
    Axis,
    Scene,
    WallRelation,
    auto_align_floor,
    connect_walls,
    disconnect_walls,
    export_all_room_pcl_transforms,
    export_all_room_xf_files,
    export_room_full_res,
    fit_cuboid_to_room,
    load_room,
    optimize_room_positions,
    project_room,
    remove_ceiling,
    rotate_kinfu_room,
    rotate_room,
    rotate_room_to_match_walls,
    suggest_corners,
    translate_room,
)
from housescan_tpu_torch.rooms.corners import (
    accept_corner_suggestion,
    add_corner_from_planes,
    adopt_bbox_corners,
    plane_from_points,
)
from housescan_tpu_torch.rooms.manip import duplicate_plane, move_wall, swap_room_positions
from housescan_tpu_torch.rooms.types import Plane, Room
from housescan_tpu_torch.testing import make_synthetic_room_dir

CPU = "cpu"


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture
def room_dir(tmp_path):
    return make_synthetic_room_dir(tmp_path / "room_a", dims=(4.0, 2.5, 5.0), seed=1)


@pytest.fixture
def scene():
    return Scene(device=CPU)


def rot_about(axis, theta):
    return axis_angle_mat(torch.tensor(axis, dtype=torch.float32), theta).numpy()


class TestLoadRoom:
    def test_load_sets_inward_normals(self, scene, room_dir):
        room = load_room(scene, room_dir)
        center = room.mean()
        for p in room.planes:
            assert float(np.dot(center - p.mean(), p.normal)) > 0, "normal must face room center"

    def test_load_room_identity_proj(self, scene, room_dir):
        np.testing.assert_array_equal(load_room(scene, room_dir).proj, np.eye(4, dtype=np.float32))

    def test_ids_unique(self, scene, room_dir):
        ids = load_room(scene, room_dir).get_ids()
        assert len(ids) == len(set(ids))

    def test_missing_dir_raises(self, scene, tmp_path):
        with pytest.raises(FileNotFoundError):
            load_room(scene, tmp_path / "nope")


class TestRoomTransforms:
    def test_translate_room_moves_everything(self, scene, room_dir):
        room = load_room(scene, room_dir)
        off = np.array([1.0, 2.0, 3.0], np.float32)
        moved = translate_room(room, off, device=CPU)
        np.testing.assert_allclose(moved.mean(), room.mean() + off, atol=1e-5)
        np.testing.assert_allclose(moved.proj[3, :3], off, atol=1e-6)
        for p0, p1 in zip(room.planes, moved.planes):
            d0 = room.cloud.points @ p0.normal - p0.d
            d1 = moved.cloud.points @ p1.normal - p1.d
            np.testing.assert_allclose(d1, d0, atol=1e-4)

    def test_rotate_room_preserves_shape(self, scene, room_dir):
        room = load_room(scene, room_dir)
        rotated = rotate_room(room, rot_about([0.0, 1.0, 0.0], 0.7), device=CPU)
        np.testing.assert_allclose(rotated.mean(), room.mean(), atol=1e-4)
        d0 = np.linalg.norm(room.cloud.points[0] - room.cloud.points[100])
        d1 = np.linalg.norm(rotated.cloud.points[0] - rotated.cloud.points[100])
        assert d1 == pytest.approx(d0, abs=1e-4)
        for p0, p1 in zip(room.planes, rotated.planes):
            d0s = room.cloud.points @ p0.normal - p0.d
            d1s = rotated.cloud.points @ p1.normal - p1.d
            np.testing.assert_allclose(d1s, d0s, atol=1e-3)

    def test_proj_replays_the_motion(self, scene, room_dir):
        room0 = load_room(scene, room_dir)
        orig = room0.cloud.points.copy()
        room1 = rotate_room(room0, rot_about([0.2, 1.0, 0.1], 1.1), device=CPU)
        room2 = translate_room(room1, np.array([3.0, 0.5, -2.0], np.float32), device=CPU)
        replayed = apply_proj4(torch.from_numpy(room2.proj), torch.from_numpy(orig)).numpy()
        np.testing.assert_allclose(replayed, room2.cloud.points, atol=1e-3)

    def test_project_room_composes_proj(self, scene, room_dir):
        room = load_room(scene, room_dir)
        proj = np.eye(4, dtype=np.float32)
        proj[:3, :3] = rot_about([0.0, 1.0, 0.0], 0.3)
        proj[3, :3] = [1.0, -0.5, 2.0]
        moved = project_room(room, proj, device=CPU)
        np.testing.assert_allclose(moved.proj, proj, atol=1e-6)
        np.testing.assert_allclose(moved.cloud.points, room.cloud.points @ proj[:3, :3] + proj[3, :3],
                                   atol=1e-4)

    def test_rotate_kinfu_room_flips_y(self, scene, room_dir):
        room = load_room(scene, room_dir)
        flipped = rotate_kinfu_room(room, device=CPU)
        rel0 = room.cloud.points - room.mean()
        rel1 = flipped.cloud.points - flipped.mean()
        np.testing.assert_allclose(rel1[:, 1], -rel0[:, 1], atol=1e-4)

    def test_remove_ceiling_drops_top_20pct(self, scene, room_dir):
        room = load_room(scene, room_dir)
        n = len(room.cloud.points)
        cut = remove_ceiling(room, fraction=0.2, device=CPU)
        assert len(cut.cloud.points) <= n - n // 5 + 5  # ties may keep a few
        assert cut.cloud.points[:, 1].max() < room.cloud.points[:, 1].max()


class TestCorners:
    def test_suggest_adopts_8_for_cuboid_room(self, scene, room_dir):
        room = suggest_corners(scene, load_room(scene, room_dir), cutoff_factor=1.2)
        assert len(room.corners) == 8
        assert room.suggested_corners == []
        for _, c in room.corners:
            np.testing.assert_allclose(np.abs(c), np.array([4.0, 2.5, 5.0]) / 2, atol=1e-3)

    def test_suggestions_not_adopted_when_corners_exist(self, scene, room_dir):
        room = load_room(scene, room_dir)
        room = add_corner_from_planes(scene, room, tuple(p.plane_id for p in room.planes[::2]))
        assert room is not None and len(room.corners) == 1
        room = suggest_corners(scene, room)
        assert len(room.corners) == 1
        assert len(room.suggested_corners) == 8

    def test_accept_suggestion(self, scene, room_dir):
        room = load_room(scene, room_dir)
        room = add_corner_from_planes(scene, room, tuple(p.plane_id for p in room.planes[::2]))
        room = suggest_corners(scene, room)
        sugg_id = room.suggested_corners[0][0]
        room = accept_corner_suggestion(scene, room, sugg_id)
        assert len(room.corners) == 2
        assert all(s[0] != sugg_id for s in room.suggested_corners)

    def test_parallel_planes_give_no_corner(self, scene, room_dir):
        room = load_room(scene, room_dir)
        xs = sorted(room.planes, key=lambda p: -abs(p.normal[0]))[:2]  # the two x walls
        assert add_corner_from_planes(scene, room, (xs[0].plane_id, xs[1].plane_id,
                                                    room.planes[2].plane_id)) is None

    def test_adopt_bbox_corners_and_plane_from_points(self, scene, room_dir):
        room = load_room(scene, room_dir)
        room = add_corner_from_planes(scene, room, tuple(p.plane_id for p in room.planes[::2]))
        room = suggest_corners(scene, room)
        room = room.__class__(**{**room.__dict__, "corners": []})
        room = adopt_bbox_corners(scene, room)
        assert len(room.corners) == 8
        pts = np.array([[0, 0, 1.0], [1, 0, 1.0], [0, 1, 1.0], [1, 1, 1.0]], np.float32)
        room = plane_from_points(scene, room, pts)
        np.testing.assert_allclose(np.abs(room.planes[0].normal), [0, 0, 1], atol=1e-5)
        assert room.planes[0].d == pytest.approx(1.0, abs=1e-5)


class TestCuboidRoom:
    def test_fit_cuboid_replaces_geometry(self, scene, room_dir):
        room = suggest_corners(scene, load_room(scene, room_dir))
        old_corner_ids = [i for i, _ in room.corners]
        new_room, rmse, steps = fit_cuboid_to_room(scene, room)
        assert rmse < 0.01
        assert len(new_room.planes) == 6
        assert [i for i, _ in new_room.corners] == old_corner_ids
        for p in new_room.planes:
            assert p.bounds.shape == (4, 3)
            assert np.abs(p.bounds @ p.normal - p.d).max() < 1e-3

    def test_fit_requires_8_corners(self, scene, room_dir):
        assert fit_cuboid_to_room(scene, load_room(scene, room_dir)) is None

    def test_fit_purges_stale_wall_connections(self, scene, tmp_path):
        d1 = make_synthetic_room_dir(tmp_path / "r1", seed=1)
        d2 = make_synthetic_room_dir(tmp_path / "r2", seed=2, offset=np.array([6.0, 0, 0]))
        r1 = suggest_corners(scene, load_room(scene, d1))
        r2 = suggest_corners(scene, load_room(scene, d2))
        p1 = max(r1.planes, key=lambda p: p.normal[0])
        p2 = max(r2.planes, key=lambda p: -p.normal[0])
        assert connect_walls(scene, p1.plane_id, p2.plane_id, WallRelation.opposite(0.1)) is not None
        assert len(scene.connected_walls) == 1
        fit_cuboid_to_room(scene, r1)
        assert scene.connected_walls == []


class TestAutoAlign:
    def test_align_floor_after_rotation(self, scene, room_dir):
        room = rotate_room(load_room(scene, room_dir), rot_about([1.0, 0.3, 0.2], 0.4), device=CPU)
        scene.update_room(room)
        aligned = auto_align_floor(scene, room)
        best = max(aligned.planes, key=lambda p: p.normal[1])
        np.testing.assert_allclose(best.normal, [0, 1, 0], atol=1e-4)


class TestWallsAndOptimize:
    def _two_connected_rooms(self, scene, tmp_path, gap=0.35):
        d1 = make_synthetic_room_dir(tmp_path / "r1", seed=1)
        d2 = make_synthetic_room_dir(tmp_path / "r2", seed=2, offset=np.array([4.0 + gap, 0.0, 0.0]))
        r1 = suggest_corners(scene, load_room(scene, d1))
        r2 = suggest_corners(scene, load_room(scene, d2))
        p1 = min(r1.planes, key=lambda p: p.normal[0])  # wall at x = +2, normal -X
        p2 = max(r2.planes, key=lambda p: p.normal[0])  # wall at x = gap + 2, normal +X
        return r1, r2, p1, p2

    def test_connect_and_disconnect(self, scene, tmp_path):
        r1, r2, p1, p2 = self._two_connected_rooms(scene, tmp_path)
        assert connect_walls(scene, p1.plane_id, p2.plane_id, WallRelation.opposite(0.1)) == Axis.X
        connect_walls(scene, p2.plane_id, p1.plane_id, WallRelation.same())
        assert len(scene.connected_walls) == 1
        disconnect_walls(scene, p1.plane_id, p2.plane_id)
        assert scene.connected_walls == []

    def test_connect_same_room_rejected(self, scene, room_dir):
        pids = [p.plane_id for p in load_room(scene, room_dir).planes]
        assert connect_walls(scene, pids[0], pids[1], WallRelation.same()) is None

    def test_optimize_sets_wall_gap_to_thickness(self, scene, tmp_path):
        thickness = 0.1
        r1, r2, p1, p2 = self._two_connected_rooms(scene, tmp_path, gap=0.35)
        connect_walls(scene, p1.plane_id, p2.plane_id, WallRelation.opposite(thickness))
        results = optimize_room_positions(scene)
        assert len(results) == 1
        axis, comp_size, rmse = results[0]
        assert axis == Axis.X and rmse == pytest.approx(0.0, abs=1e-5)
        r1n, r2n = scene.rooms[r1.room_id], scene.rooms[r2.room_id]
        gap = abs(float(r1n.find_plane(p1.plane_id).mean()[0] - r2n.find_plane(p2.plane_id).mean()[0]))
        assert gap == pytest.approx(thickness, abs=1e-3)
        np.testing.assert_allclose(r1n.corner_mean(), r1.corner_mean(), atol=1e-4)

    def test_optimize_requires_corners(self, scene, tmp_path):
        d1 = make_synthetic_room_dir(tmp_path / "r1", seed=1)
        d2 = make_synthetic_room_dir(tmp_path / "r2", seed=2, offset=np.array([5.0, 0, 0]))
        r1, r2 = load_room(scene, d1), load_room(scene, d2)
        p1 = min(r1.planes, key=lambda p: p.normal[0])
        p2 = max(r2.planes, key=lambda p: p.normal[0])
        connect_walls(scene, p1.plane_id, p2.plane_id, WallRelation.same())
        with pytest.raises(ValueError, match="no corners"):
            optimize_room_positions(scene)


class TestManip:
    def test_move_wall_drags_corners(self, scene, room_dir):
        room = fit_cuboid_to_room(scene, suggest_corners(scene, load_room(scene, room_dir)))[0]
        wall = room.planes[0]
        before = {i: c.copy() for i, c in room.corners}
        moved_room = move_wall(scene, wall.plane_id, wall.normal, step=0.05)
        assert abs(moved_room.find_plane(wall.plane_id).d - wall.d) == pytest.approx(0.05, abs=1e-5)
        assert sum(1 for i, c in moved_room.corners if not np.allclose(c, before[i])) == 4

    def test_duplicate_plane(self, scene, room_dir):
        room = load_room(scene, room_dir)
        n0 = len(room.planes)
        dup = duplicate_plane(scene, room.planes[0].plane_id)
        assert len(scene.rooms[room.room_id].planes) == n0 + 1
        assert dup.plane_id != room.planes[0].plane_id

    def test_swap_room_positions(self, scene, tmp_path):
        r1 = load_room(scene, make_synthetic_room_dir(tmp_path / "r1", seed=1))
        r2 = load_room(scene, make_synthetic_room_dir(tmp_path / "r2", seed=2,
                                                      offset=np.array([8.0, 0, 0])))
        m1, m2 = r1.mean().copy(), r2.mean().copy()
        swap_room_positions(scene, r1.room_id, r2.room_id)
        np.testing.assert_allclose(scene.rooms[r1.room_id].mean(), m2, atol=1e-4)
        np.testing.assert_allclose(scene.rooms[r2.room_id].mean(), m1, atol=1e-4)


class TestExport:
    def test_xf_export_and_full_res(self, scene, tmp_path):
        room_dir = make_synthetic_room_dir(tmp_path / "room", seed=3)
        room = translate_room(load_room(scene, room_dir), np.array([2.0, 0.0, 1.0], np.float32),
                              device=CPU)
        scene.update_room(room)
        xf_files = export_all_room_xf_files(scene, tmp_path / "xf")
        assert len(xf_files) == 1
        np.testing.assert_allclose(load_xf(xf_files[0]), room.proj, atol=1e-6)
        out = export_room_full_res(room, tmp_path / "placed.pcd",
                                   full_res_path=room_dir / "cloud_bin.pcd", device=CPU)
        np.testing.assert_allclose(load_pcd(out).points,
                                   load_pcd(room_dir / "cloud_bin.pcd").points + [2.0, 0.0, 1.0],
                                   atol=1e-4)

    def test_pcl_command_lines(self, scene, tmp_path):
        load_room(scene, make_synthetic_room_dir(tmp_path / "roomx", seed=4))
        cmds = export_all_room_pcl_transforms(scene)
        assert len(cmds) == 1
        assert cmds[0].startswith("pcl_transform_point_cloud") and "-matrix" in cmds[0]
        assert len(cmds[0].split("-matrix ")[1].split(",")) == 16


def _three_room_cycle(scene, tmp_path, tag=""):
    """Load 3 rooms, auto-corner, cuboid-fit, connect walls along X,
    optimise, export (TestEndToEndSlice's flow). Returns (rooms, dirs,
    results, xf paths, placed outputs)."""
    dims = (4.0, 2.5, 5.0)
    gaps = [0.4, 0.7]
    dirs = [
        make_synthetic_room_dir(tmp_path / f"room{i}", dims=dims, seed=10 + i,
                                offset=np.array([i * dims[0] + sum(gaps[:i], 0.0) + 0.35 * i, 0, 0]))
        for i in range(3)
    ]
    rooms, rmses = [], []
    for d in dirs:
        r, rmse, _ = fit_cuboid_to_room(scene, suggest_corners(scene, load_room(scene, d)))
        rooms.append(r)
        rmses.append(rmse)
    for a, b in ((0, 1), (1, 2)):
        pa = min(rooms[a].planes, key=lambda p: p.normal[0])
        pb = max(rooms[b].planes, key=lambda p: p.normal[0])
        assert connect_walls(scene, pa.plane_id, pb.plane_id, WallRelation.opposite(0.12)) == Axis.X
    results = optimize_room_positions(scene)
    xfs = export_all_room_xf_files(scene, tmp_path / f"xf{tag}")
    placed = [
        export_room_full_res(scene.rooms[r.room_id], tmp_path / f"placed{tag}{k}.ply",
                             full_res_path=d / "cloud_bin.pcd", device=scene.device)
        for k, (r, d) in enumerate(zip(rooms, dirs))
    ]
    return rooms, rmses, results, xfs, placed


class TestEndToEndSlice:
    def test_full_pipeline(self, scene, tmp_path):
        """The reference's in-repo capability in one flow: 3 rooms loaded,
        auto-cornered, cuboid-fitted, walls connected, positions
        optimised, transforms and full-resolution placed clouds exported."""
        rooms, rmses, results, xfs, placed = _three_room_cycle(scene, tmp_path)
        assert all(r < 0.01 for r in rmses)
        assert all(r[2] < 1e-4 for r in results)
        centers = sorted(float(scene.rooms[r.room_id].corner_mean()[0]) for r in rooms)
        for c0, c1 in zip(centers, centers[1:]):
            assert (c1 - c0) == pytest.approx(4.0 + 0.12, abs=1e-3)
        assert len(xfs) == 3
        assert all(p.exists() for p in placed)


class TestRotateToMatchWalls:
    def _two_rooms(self, scene, tmp_path):
        return [
            load_room(scene, make_synthetic_room_dir(tmp_path / f"room{i}", dims=(4.0, 2.5, 5.0),
                                                     seed=i, offset=np.array([i * 4.4, 0, 0])))
            for i in range(2)
        ]

    def test_room_branch_makes_walls_antiparallel(self, scene, tmp_path):
        ra, rb = self._two_rooms(scene, tmp_path)
        p1 = max(ra.planes, key=lambda p: p.normal[0])
        p2 = max(rb.planes, key=lambda p: p.normal[0])
        got = rotate_room_to_match_walls(scene, p1.plane_id, p2.plane_id)
        assert isinstance(got, Room)
        np.testing.assert_allclose(got.find_plane(p1.plane_id).normal, -p2.normal, atol=1e-5)
        assert len(got.cloud.points) == len(ra.cloud.points)
        ext_a = np.sort(ra.cloud.points.max(0) - ra.cloud.points.min(0))
        ext_b = np.sort(got.cloud.points.max(0) - got.cloud.points.min(0))
        np.testing.assert_allclose(ext_a, ext_b, atol=1e-3)
        assert scene.rooms[got.room_id] is got

    def test_bare_plane_branch_adds_rotated_copy(self, scene, tmp_path):
        rb = self._two_rooms(scene, tmp_path)[1]
        p2 = max(rb.planes, key=lambda p: p.normal[0])
        bounds = np.array([[0, 0, 0], [0.8, -0.6, 0], [0.8, -0.6, 1], [0, 0, 1]], np.float32)
        free = Plane(plane_id=scene.gen_id(), normal=np.array([0.6, 0.8, 0.0], np.float32), d=0.0,
                     bounds=bounds)
        scene.planes[free.plane_id] = free
        rooms_before = dict(scene.rooms)
        got = rotate_room_to_match_walls(scene, free.plane_id, p2.plane_id)
        assert not isinstance(got, Room)
        np.testing.assert_allclose(got.normal, p2.normal, atol=1e-5)
        assert got.plane_id != free.plane_id
        assert scene.planes[free.plane_id] is free and scene.planes[got.plane_id] is got
        np.testing.assert_allclose(got.mean(), free.mean(), atol=1e-5)
        d_old = np.linalg.norm(bounds[:, None] - bounds[None, :], axis=-1)
        d_new = np.linalg.norm(got.bounds[:, None] - got.bounds[None, :], axis=-1)
        np.testing.assert_allclose(d_new, d_old, atol=1e-5)
        np.testing.assert_allclose(got.bounds @ got.normal, np.full(4, got.d), atol=1e-5)
        assert scene.rooms == rooms_before

    def test_unknown_plane_raises(self, scene, tmp_path):
        self._two_rooms(scene, tmp_path)
        with pytest.raises(KeyError):
            rotate_room_to_match_walls(scene, 999999, 999998)


def test_entry_points_default_to_the_card():
    """Every room-stage entry point that computes takes the card unless
    the caller asks for the CPU (read from the signatures, without a
    card): a scene's functions compute on ``Scene.device``."""
    from housescan_tpu_torch import solvers
    from housescan_tpu_torch.rooms import manip
    from housescan_tpu_torch.rooms.align import rotate_plane

    assert Scene().device == "cuda"
    fns = (rotate_room, translate_room, project_room, remove_ceiling, export_room_full_res,
           rotate_kinfu_room, rotate_plane, manip.translate_plane, solvers.nelder_mead,
           solvers.fit_cuboid, solvers.fit_cuboid_batch, solvers.fit_cuboid_from_center,
           solvers.fit_cuboid_from_center_first)
    for fn in fns:
        assert inspect.signature(fn).parameters["device"].default == "cuda", fn.__name__


# --- parity with the reference's room stage ---------------------------------


def _loaded_arrays(room):
    """Everything load_room reads from disk, but the unseeded colours."""
    out = {"points": room.cloud.points, "proj": room.proj}
    for k, p in enumerate(room.planes):
        out[f"normal{k}"], out[f"d{k}"], out[f"bounds{k}"] = p.normal, np.float64(p.d), p.bounds
    return out


def _assert_same_load(port_room, ref_room):
    a, b = _loaded_arrays(port_room), _loaded_arrays(ref_room)
    assert a.keys() == b.keys()
    for k in a:
        assert np.asarray(a[k]).dtype == np.asarray(b[k]).dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.fixture(scope="module")
def port_scan_dir(tmp_path_factory):
    """A room directory written by the port's scan (128^3, 160x120, 8
    known poses of the furnished room, the XLA path)."""
    from housescan_tpu_torch.capture.replay import DepthStream
    from housescan_tpu_torch.config import Config, RansacConfig, TsdfConfig
    from housescan_tpu_torch.kinfu.camera import Intrinsics
    from housescan_tpu_torch.kinfu.scan import scan_to_room_dir
    from housescan_tpu_torch.kinfu.synthetic import furnished_room, orbit_poses, render_depth_stream

    torch.set_num_threads(1)
    intr = Intrinsics(width=160, height=120, fx=131.25, fy=131.25, cx=79.5, cy=59.5)
    cfg = Config(tsdf=TsdfConfig(resolution=128, size_m=3.2, trunc_dist=0.06),
                 ransac=RansacConfig(min_inlier_fraction=0.01, max_planes=12, n_hypotheses=1024))
    half, boxes = furnished_room()
    poses = orbit_poses(8, radius=0.25, yaw_range=6.283, pitch=0.35)
    frames = render_depth_stream(intr, poses, half, boxes, device=CPU).numpy()
    return scan_to_room_dir(DepthStream(frames=frames, intrinsics=intr),
                            tmp_path_factory.mktemp("scan") / "room", config=cfg,
                            init_pose=poses[0], use_pallas=False, downsample_to=8192,
                            known_poses=poses, device=CPU)


class TestParity:
    @pytest.fixture(autouse=True)
    def _ref(self):
        pytest.importorskip("jax")

    def test_room_dir_files_identical(self, tmp_path):
        """The port's ``make_synthetic_room_dir`` writes the reference's
        bytes (rotated and moved too)."""
        from housescan_tpu.testing import make_synthetic_room_dir as j_make

        rot = rot_about([0.3, 1.0, 0.2], 0.6)
        for kw in (dict(seed=1), dict(seed=5, noise=0.01, rot=rot, offset=np.array([1.0, 0.0, -2.0]))):
            a = make_synthetic_room_dir(tmp_path / "port", **kw)
            b = j_make(tmp_path / "ref", **kw)
            names = sorted(p.name for p in a.iterdir())
            assert names == sorted(p.name for p in b.iterdir())
            for n in names:
                assert (a / n).read_bytes() == (b / n).read_bytes(), n

    @pytest.mark.parametrize("source", ["port", "reference", "port scan"])
    def test_load_and_corners_match(self, source, tmp_path, port_scan_dir):
        from housescan_tpu import rooms as J
        from housescan_tpu.testing import make_synthetic_room_dir as j_make

        if source == "port scan":
            room_dir = port_scan_dir
        else:
            maker = make_synthetic_room_dir if source == "port" else j_make
            room_dir = maker(tmp_path / "room", seed=7, rot=rot_about([0.0, 1.0, 0.0], 0.3))
        ps, js = Scene(device=CPU), J.Scene()
        pr, jr = load_room(ps, room_dir), J.load_room(js, room_dir)
        _assert_same_load(pr, jr)
        assert len(pr.planes) >= (6 if source != "port scan" else 3)
        pr, jr = suggest_corners(ps, pr, cutoff_factor=1.3), J.suggest_corners(js, jr, cutoff_factor=1.3)
        for attr in ("corners", "suggested_corners"):
            a, b = getattr(pr, attr), getattr(jr, attr)
            assert [i for i, _ in a] == [i for i, _ in b]
            if a:
                np.testing.assert_allclose(np.stack([c for _, c in a]), np.stack([c for _, c in b]),
                                           atol=1e-4)
        assert len(pr.corners) + len(pr.suggested_corners) >= (8 if source != "port scan" else 1)

    def test_room_cycle_matches(self, tmp_path):
        """TestEndToEndSlice's flow in both packages, then a rotation,
        a ceiling cut and the kinfu flip of one room."""
        from housescan_tpu import rooms as J
        from housescan_tpu.io.xf import load_xf as j_load_xf

        ps, js = Scene(device=CPU), J.Scene()
        prooms, prmse, pres, pxf, pplaced = _three_room_cycle(ps, tmp_path, "p")
        jrooms, jrmse, jres, jxf, jplaced = _j_three_room_cycle(js, tmp_path, J)
        np.testing.assert_allclose(prmse, jrmse, atol=1e-5)
        assert [(a, n) for a, n, _ in pres] == [(a, n) for a, n, _ in jres]
        np.testing.assert_allclose([r for _, _, r in pres], [r for _, _, r in jres], atol=1e-5)
        for p, j in zip(prooms, jrooms):
            p, j = ps.rooms[p.room_id], js.rooms[j.room_id]
            # a cuboid's parametrisation is not unique (quaternion sign,
            # axes permuted with the dims), so which corner or face comes
            # k-th may differ: corners and faces are compared as sets
            np.testing.assert_allclose(p.corner_mean(), j.corner_mean(), atol=1e-4)
            _same_points(np.stack([c for _, c in p.corners]), np.stack([c for _, c in j.corners]))
            assert len(p.planes) == len(j.planes) == 6
            for a in p.planes:
                b = min(j.planes, key=lambda b: np.abs(a.normal - b.normal).sum() + abs(a.d - b.d))
                np.testing.assert_allclose(a.normal, b.normal, atol=1e-4)
                assert a.d == pytest.approx(b.d, abs=1e-4)
                _same_points(a.bounds, b.bounds)
        for a, b in zip(pxf, jxf):
            assert a.name == b.name
            np.testing.assert_allclose(load_xf(a), j_load_xf(b), atol=1e-5)
        for a, b in zip(pplaced, jplaced):
            from housescan_tpu.io.ply import load_ply as j_load_ply
            from housescan_tpu_torch.io.ply import load_ply

            np.testing.assert_allclose(load_ply(a).vertices, j_load_ply(b).vertices, atol=1e-4)

        p, j = ps.rooms[prooms[0].room_id], js.rooms[jrooms[0].room_id]
        rot = rot_about([0.2, 1.0, 0.1], 1.1)
        for pm, jm in (
            (rotate_room(p, rot, device=CPU), J.rotate_room(j, rot)),
            (rotate_kinfu_room(p, device=CPU), J.rotate_kinfu_room(j)),
            (remove_ceiling(p, 0.2, device=CPU), J.remove_ceiling(j, 0.2)),
        ):
            np.testing.assert_allclose(pm.cloud.points, jm.cloud.points, atol=1e-4)
            np.testing.assert_allclose(pm.proj, jm.proj, atol=1e-5)
            _same_points(np.stack([c for _, c in pm.corners]), np.stack([c for _, c in jm.corners]))


def _same_points(a, b, atol=1e-4):
    """Two point sets equal within ``atol``, whatever their order."""
    d = np.linalg.norm(a[:, None] - b[None], axis=-1)
    assert len(a) == len(b) and d.min(axis=1).max() < atol and d.min(axis=0).max() < atol


def _j_three_room_cycle(scene, tmp_path, J):
    """``_three_room_cycle`` through the reference's room stage, on the
    directories the port's cycle wrote."""
    dirs = [tmp_path / f"room{i}" for i in range(3)]
    rooms, rmses = [], []
    for d in dirs:
        r, rmse, _ = J.fit_cuboid_to_room(scene, J.suggest_corners(scene, J.load_room(scene, d)))
        rooms.append(r)
        rmses.append(rmse)
    for a, b in ((0, 1), (1, 2)):
        pa = min(rooms[a].planes, key=lambda p: p.normal[0])
        pb = max(rooms[b].planes, key=lambda p: p.normal[0])
        J.connect_walls(scene, pa.plane_id, pb.plane_id, J.WallRelation.opposite(0.12))
    results = J.optimize_room_positions(scene)
    xfs = J.export_all_room_xf_files(scene, tmp_path / "xfj")
    placed = [
        J.export_room_full_res(scene.rooms[r.room_id], tmp_path / f"placedj{k}.ply",
                               full_res_path=d / "cloud_bin.pcd")
        for k, (r, d) in enumerate(zip(rooms, dirs))
    ]
    return rooms, rmses, results, xfs, placed
