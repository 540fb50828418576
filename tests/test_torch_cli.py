"""The port's command line: twins of tests/test_cli.py, each subcommand
invoked as ``main([...])`` with ``--device cpu`` as a shell user would,
asserting on the persisted scene; then ``--device`` itself, ``python -m
housescan_tpu_torch.cli`` in a subprocess, and parity with the JAX
package: ``demo --rooms 2`` in both places the same rooms, corners within
3e-4 m (the room stage's tolerance, tests/test_torch_rooms.py)."""

import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("jax")

import numpy as np

from housescan_tpu_torch.cli.main import main as cli_main
from housescan_tpu_torch.io.checkpoint import load_scene as _load_scene
from housescan_tpu_torch.testing import make_synthetic_room_dir

REPO = Path(__file__).resolve().parents[1]


def main(argv):
    return cli_main(["--device", "cpu", *argv])


def load_scene(path):
    return _load_scene(path, device="cpu")


@pytest.fixture
def scene_path(tmp_path):
    return str(tmp_path / "scene.housescan")


@pytest.fixture
def two_room_scene(tmp_path, scene_path):
    """Two synthetic rooms loaded, cornered, and cuboid-fitted via the CLI."""
    dims = (4.0, 2.5, 5.0)
    for i in range(2):
        d = make_synthetic_room_dir(
            tmp_path / f"room{i}",
            dims=dims,
            seed=i,
            offset=np.array([i * (dims[0] + 0.4), 0, 0]),
        )
        main(["--scene", scene_path, "add-room", str(d)])
    scene = load_scene(scene_path)
    for rid in sorted(scene.rooms):
        main(["--scene", scene_path, "suggest", "--room", str(rid)])
        main(["--scene", scene_path, "fit-cuboid", "--room", str(rid)])
    return scene_path


def _rooms(scene_path):
    return load_scene(scene_path).rooms


def test_refuse_two_streams_2d_mesh(tmp_path):
    """`refuse`: offline DP x SP re-fuse of two recorded streams at
    their recorded trajectories on the 2 x 4 rooms-x-slab mesh (every
    entry the CPU), writing standard room directories."""
    from housescan_tpu_torch.capture.replay import record_stream
    from housescan_tpu_torch.kinfu.camera import Intrinsics
    from housescan_tpu_torch.kinfu.synthetic import (
        furnished_room,
        orbit_poses,
        render_depth_stream,
    )

    intr = Intrinsics(width=160, height=120, fx=131.25, fy=131.25,
                      cx=79.5, cy=59.5)
    half, boxes = furnished_room()
    streams, trajfiles = [], []
    for ri in range(2):
        poses = orbit_poses(3 + ri, radius=0.25, yaw_range=0.1,
                            pitch=0.25 + 0.1 * ri)
        frames = render_depth_stream(intr, poses, half, boxes=boxes, device="cpu")
        sp = tmp_path / f"r{ri}.npz"
        record_stream(sp, frames, intr, poses=poses)
        tp = tmp_path / f"t{ri}.npz"
        np.savez(tp, poses=np.asarray(poses, np.float32))
        streams.append(str(sp))
        trajfiles.append(str(tp))
    main([
        "refuse", str(tmp_path / "out"), *streams,
        "--trajectories", *trajfiles,
        "--devices", "2x4", "--resolution", "64", "--trunc", "0.1",
    ])
    for ri in range(2):
        d = tmp_path / "out" / f"r{ri}"
        assert (d / "cloud_downsampled.pcd").exists()
        assert (d / "planes.txt").exists()
        traj = np.load(d / "trajectory.npz")["poses"]
        assert traj.shape == (3 + ri, 4, 4)  # unpadded original lengths


class TestManipCommands:
    def test_swap(self, two_room_scene):
        rooms = _rooms(two_room_scene)
        (r1, r2) = sorted(rooms)
        m1, m2 = rooms[r1].mean(), rooms[r2].mean()
        main(["--scene", two_room_scene, "swap", str(r1), str(r2)])
        rooms2 = _rooms(two_room_scene)
        np.testing.assert_allclose(rooms2[r1].mean(), m2, atol=1e-4)
        np.testing.assert_allclose(rooms2[r2].mean(), m1, atol=1e-4)

    def test_swap_unknown_room_exits(self, two_room_scene):
        with pytest.raises(SystemExit):
            main(["--scene", two_room_scene, "swap", "999999", "999998"])

    def test_duplicate_then_delete_plane(self, two_room_scene):
        rooms = _rooms(two_room_scene)
        rid = sorted(rooms)[0]
        pid = rooms[rid].planes[0].plane_id
        n_before = len(rooms[rid].planes)
        main(["--scene", two_room_scene, "duplicate-plane", str(pid)])
        rooms2 = _rooms(two_room_scene)
        assert len(rooms2[rid].planes) == n_before + 1
        new_ids = {p.plane_id for p in rooms2[rid].planes} - {
            p.plane_id for p in rooms[rid].planes
        }
        assert len(new_ids) == 1
        main(["--scene", two_room_scene, "delete-plane", str(new_ids.pop())])
        assert len(_rooms(two_room_scene)[rid].planes) == n_before

    def test_move_wall_shifts_plane_and_corners(self, two_room_scene):
        rooms = _rooms(two_room_scene)
        rid = sorted(rooms)[0]
        room = rooms[rid]
        # pick the +x-most wall (cuboid-fitted: corners lie on it)
        plane = min(room.planes, key=lambda p: p.normal[0])
        offset = np.array([1.0, 0.0, 0.0], np.float32) * 0.05
        want_d = plane.d + float(plane.normal @ offset)
        main(
            ["--scene", two_room_scene, "move-wall", str(plane.plane_id),
             "1", "0", "0", "--step", "0.05"]
        )
        room2 = _rooms(two_room_scene)[rid]
        got = next(p for p in room2.planes if p.plane_id == plane.plane_id)
        assert abs(got.d - want_d) < 1e-5
        np.testing.assert_allclose(got.bounds, plane.bounds + offset, atol=1e-5)
        # the wall's 4 corners moved with it, the other 4 stayed
        moved = sum(
            1
            for (ca, cb) in zip(room.corners, room2.corners)
            if not np.allclose(ca[1], cb[1])
        )
        assert moved == 4

    def test_plane_from_points(self, two_room_scene):
        rooms = _rooms(two_room_scene)
        rid = sorted(rooms)[0]
        n_before = len(rooms[rid].planes)
        main(
            ["--scene", two_room_scene, "plane-from-points", "--room", str(rid),
             "0,0,0.5", "1,0,0.5", "0,1,0.5", "1,1,0.5"]
        )
        room2 = _rooms(two_room_scene)[rid]
        assert len(room2.planes) == n_before + 1
        p = room2.planes[0]
        assert abs(abs(p.normal[2]) - 1.0) < 1e-4  # z = 0.5 plane
        assert abs(abs(p.d) - 0.5) < 1e-4

    def test_plane_from_points_file(self, two_room_scene, tmp_path):
        rooms = _rooms(two_room_scene)
        rid = sorted(rooms)[0]
        f = tmp_path / "picked.txt"
        f.write_text("0 0 0\n1 0 0\n0 1 0\n")
        main(
            ["--scene", two_room_scene, "plane-from-points", "--room", str(rid),
             "--points-file", str(f)]
        )
        p = _rooms(two_room_scene)[rid].planes[0]
        assert abs(abs(p.normal[2]) - 1.0) < 1e-4

    def test_plane_from_points_too_few(self, two_room_scene):
        rid = str(sorted(_rooms(two_room_scene))[0])
        with pytest.raises(SystemExit):
            main(
                ["--scene", two_room_scene, "plane-from-points", "--room", rid,
                 "0,0,0", "1,0,0"]
            )


class TestCornerCommands:
    def test_corner_from_three_planes(self, tmp_path, scene_path):
        d = make_synthetic_room_dir(tmp_path / "room", dims=(4.0, 2.5, 5.0), seed=3)
        main(["--scene", scene_path, "add-room", str(d)])
        rooms = _rooms(scene_path)
        rid = sorted(rooms)[0]
        room = rooms[rid]
        # three mutually orthogonal planes intersect in one corner
        px = min(room.planes, key=lambda p: abs(abs(p.normal[0]) - 1))
        py = min(room.planes, key=lambda p: abs(abs(p.normal[1]) - 1))
        pz = min(room.planes, key=lambda p: abs(abs(p.normal[2]) - 1))
        main(
            ["--scene", scene_path, "corner", "--room", str(rid),
             str(px.plane_id), str(py.plane_id), str(pz.plane_id)]
        )
        assert len(_rooms(scene_path)[rid].corners) == 1

    def test_accept_corner(self, tmp_path, scene_path):
        d = make_synthetic_room_dir(tmp_path / "room", dims=(4.0, 2.5, 5.0), seed=4)
        main(["--scene", scene_path, "add-room", str(d)])
        rid = sorted(_rooms(scene_path))[0]
        # first suggest auto-adopts the 8 cuboid corners; a second pass
        # stores fresh suggestions (corners now exist)
        main(["--scene", scene_path, "suggest", "--room", str(rid)])
        main(["--scene", scene_path, "suggest", "--room", str(rid)])
        room = _rooms(scene_path)[rid]
        assert room.suggested_corners
        sid = room.suggested_corners[0][0]
        n = len(room.corners)
        main(["--scene", scene_path, "accept-corner", "--room", str(rid), str(sid)])
        room2 = _rooms(scene_path)[rid]
        assert len(room2.corners) == n + 1
        assert all(s[0] != sid for s in room2.suggested_corners)

    def test_accept_corner_unknown_id_exits(self, tmp_path, scene_path):
        d = make_synthetic_room_dir(tmp_path / "room", dims=(4.0, 2.5, 5.0), seed=5)
        main(["--scene", scene_path, "add-room", str(d)])
        rid = str(sorted(_rooms(scene_path))[0])
        with pytest.raises(SystemExit):
            main(["--scene", scene_path, "accept-corner", "--room", rid, "424242"])


class TestRotateAndRender:
    def test_rotate_room_branch(self, two_room_scene):
        rooms = _rooms(two_room_scene)
        r1, r2 = sorted(rooms)
        # Both +X-facing walls -> target is flipped, a 180-degree rotation.
        p1 = max(rooms[r1].planes, key=lambda p: p.normal[0])
        p2 = max(rooms[r2].planes, key=lambda p: p.normal[0])
        main(["--scene", two_room_scene, "rotate",
              str(p1.plane_id), str(p2.plane_id)])
        rooms2 = _rooms(two_room_scene)
        got = rooms2[r1].find_plane(p1.plane_id)
        np.testing.assert_allclose(got.normal, -p2.normal, atol=1e-5)
        # room 2 untouched
        np.testing.assert_allclose(
            rooms2[r2].cloud.points, rooms[r2].cloud.points
        )

    def test_rotate_bare_plane_branch_persists(self, two_room_scene):
        """A free-standing plane 1 gains a rotated copy that SURVIVES the
        save/load round trip (checkpoint v4 free planes)."""
        from housescan_tpu_torch.io.checkpoint import save_scene
        from housescan_tpu_torch.rooms.types import Plane

        scene = load_scene(two_room_scene)
        free = Plane(
            plane_id=scene.gen_id(),
            normal=np.array([0.6, 0.8, 0.0], np.float32),
            d=0.25,
            bounds=np.array(
                [[0.15, 0.2, 0], [0.95, -0.4, 0], [0.95, -0.4, 1],
                 [0.15, 0.2, 1]], np.float32,
            ),
        )
        scene.planes[free.plane_id] = free
        save_scene(scene, two_room_scene)
        rooms = _rooms(two_room_scene)
        p2 = max(
            rooms[sorted(rooms)[1]].planes, key=lambda p: p.normal[0]
        )
        main(["--scene", two_room_scene, "rotate",
              str(free.plane_id), str(p2.plane_id)])
        loaded = load_scene(two_room_scene)
        new = [
            p for pid, p in loaded.planes.items() if pid != free.plane_id
        ]
        assert len(new) == 1
        np.testing.assert_allclose(new[0].normal, p2.normal, atol=1e-5)
        assert free.plane_id in loaded.planes  # original kept

    def test_rotate_unknown_plane_exits(self, two_room_scene):
        with pytest.raises(SystemExit):
            main(["--scene", two_room_scene, "rotate", "999999", "999998"])

    def test_render_auto_framed(self, two_room_scene, tmp_path):
        out = tmp_path / "scene.ppm"
        main(["--scene", two_room_scene, "render", "--out", str(out),
              "--width", "320", "--height", "240"])
        assert out.exists()
        data = out.read_bytes()
        assert data.startswith(b"P6\n320 240\n255\n")
        img = np.frombuffer(
            data[len(b"P6\n320 240\n255\n"):], np.uint8
        ).reshape(240, 320, 3)
        # Auto-framing actually put the rooms in view: a meaningful
        # fraction of pixels differ from the background (0.08*255=20).
        nonbg = (np.abs(img.astype(int) - 20) > 4).any(axis=-1).mean()
        assert nonbg > 0.05

    def test_render_explicit_eye(self, two_room_scene, tmp_path):
        out = tmp_path / "eye.ppm"
        main(["--scene", two_room_scene, "render", "--out", str(out),
              "--width", "160", "--height", "120",
              "--eye", "2,-6,-6", "--look-at", "2,1,2"])
        assert out.exists()

    def test_render_empty_scene_exits(self, scene_path, tmp_path):
        with pytest.raises(SystemExit):
            main(["--scene", scene_path, "render",
                  "--out", str(tmp_path / "x.ppm")])


class TestDevice:
    def test_default_device_is_the_card(self, monkeypatch):
        """Without --device the subcommands get ``cuda``; nothing falls
        back to the CPU."""
        import importlib

        cli = importlib.import_module("housescan_tpu_torch.cli.main")
        seen = {}
        monkeypatch.setattr(cli, "cmd_info", lambda args: seen.setdefault("device", args.device))
        cli.main(["info"])
        assert seen["device"] == "cuda"

    def test_named_device_fills_the_mesh(self, tmp_path, monkeypatch):
        """scan-building --sharded with one named device: a mesh of it."""
        import housescan_tpu_torch.kinfu.building as building
        from housescan_tpu_torch.capture.replay import record_stream
        from housescan_tpu_torch.kinfu.camera import Intrinsics

        intr = Intrinsics(16, 8, 10.0, 10.0, 7.5, 3.5)
        sp = tmp_path / "r.npz"
        record_stream(sp, np.ones((2, 8, 16), np.float32), intr)
        seen = {}

        def fake_scan_building(rooms, out_dir, **kw):
            seen.update(kw)
            raise SystemExit("stop")

        monkeypatch.setattr(building, "scan_building", fake_scan_building)
        with pytest.raises(SystemExit, match="stop"):
            cli_main(["--device", "cpu", "scan-building", "--sharded", str(tmp_path / "o"),
                      str(sp)])
        assert [str(d) for d in seen["mesh"].devices] == ["cpu"]
        assert seen["device"] == "cpu"

    def test_cuda_mesh_raises_without_cards(self, tmp_path):
        import torch

        if torch.cuda.is_available():
            pytest.skip("a card is visible: the mesh takes it")
        from housescan_tpu_torch.capture.replay import record_stream
        from housescan_tpu_torch.kinfu.camera import Intrinsics

        sp = tmp_path / "r.npz"
        record_stream(sp, np.ones((2, 8, 16), np.float32), Intrinsics(16, 8, 10.0, 10.0, 7.5, 3.5))
        np.savez(tmp_path / "t.npz", poses=np.tile(np.eye(4, dtype=np.float32), (2, 1, 1)))
        with pytest.raises(ValueError, match="CUDA devices"):
            cli_main(["refuse", str(tmp_path / "o"), str(sp), "--trajectories",
                      str(tmp_path / "t.npz"), "--devices", "1x1"])

    def test_python_m_entry_point(self, tmp_path):
        proc = subprocess.run(
            [sys.executable, "-m", "housescan_tpu_torch.cli", "--device", "cpu",
             "--scene", str(tmp_path / "s.housescan"), "info"],
            cwd=REPO, capture_output=True, text=True, timeout=300)
        assert proc.returncode == 0, proc.stderr
        assert proc.stdout.startswith("scene: 0 rooms, 0 wall connections")


def test_demo_places_the_same_rooms_as_reference(tmp_path, monkeypatch, capsys):
    from housescan_tpu.cli.main import main as j_main
    from housescan_tpu.io.checkpoint import load_scene as j_load_scene

    monkeypatch.setenv("HOUSESCAN_COMPILE_CACHE", "off")
    monkeypatch.chdir(tmp_path)
    main(["--scene", "port.housescan", "demo", "--rooms", "2", "--out", "port_rooms"])
    port_out = capsys.readouterr().out
    j_main(["--scene", "ref.housescan", "demo", "--rooms", "2", "--out", "ref_rooms"])
    ref_out = capsys.readouterr().out
    assert port_out.splitlines()[-1] == "demo scene saved to port.housescan"
    assert len(port_out.splitlines()) == len(ref_out.splitlines())
    port, ref = load_scene("port.housescan"), j_load_scene("ref.housescan")
    assert sorted(port.rooms) == sorted(ref.rooms) and len(port.rooms) == 2
    assert len(port.connected_walls) == len(ref.connected_walls) == 1
    for rid in ref.rooms:
        pc = np.stack([c for _, c in port.rooms[rid].corners])
        rc = np.stack([c for _, c in ref.rooms[rid].corners])
        assert pc.shape == rc.shape == (8, 3)
        # as sets: each corner's nearest counterpart within 3e-4 m
        d = np.linalg.norm(pc[:, None] - rc[None], axis=-1)
        assert d.min(axis=1).max() < 3e-4 and d.min(axis=0).max() < 3e-4
    port_xf = sorted((tmp_path / "port_rooms" / "xf").glob("*.xf"))
    ref_xf = sorted((tmp_path / "ref_rooms" / "xf").glob("*.xf"))
    assert [p.name for p in port_xf] == [p.name for p in ref_xf] and port_xf
    for p, r in zip(port_xf, ref_xf):
        np.testing.assert_allclose(np.loadtxt(p), np.loadtxt(r), atol=3e-4)
