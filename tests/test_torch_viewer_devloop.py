"""The port's headless viewer, devloop, metrics and RANSAC: twins of
tests/test_viewer_devloop.py, then parity with the JAX package's viewer
on one scene (the reference's scene loaded into the port through a
checkpoint, so both hold the same arrays): the images and the picks are
exactly equal.

``reload_framework`` re-executes every ``housescan_tpu_torch`` module in
place, which would leave the worker's later test files with new classes
and fresh module state: the reload tests run in a subprocess."""

import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

pytest.importorskip("jax")

import numpy as np
import torch

from housescan_tpu.io import checkpoint as j_checkpoint
from housescan_tpu.rooms import Scene as JScene
from housescan_tpu.rooms import load_room as j_load_room
from housescan_tpu.rooms import suggest_corners as j_suggest_corners
from housescan_tpu.viewer import frame_scene as j_frame_scene
from housescan_tpu.viewer import look_at_pose as j_look_at_pose
from housescan_tpu.viewer import pick as j_pick
from housescan_tpu.viewer import render_scene as j_render_scene
from housescan_tpu_torch.io.checkpoint import load_scene
from housescan_tpu_torch.kinfu.camera import Intrinsics
from housescan_tpu_torch.rooms import Scene, load_room, suggest_corners
from housescan_tpu_torch.testing import cuboid_room_points, make_synthetic_room_dir
from housescan_tpu_torch.viewer import (
    frame_scene,
    look_at_pose,
    pick,
    render_scene,
    visible_objects,
)

INTR = Intrinsics(width=160, height=120, fx=131.25, fy=131.25, cx=79.5, cy=59.5)
REPO = Path(__file__).resolve().parents[1]


@pytest.fixture
def scene_with_room(tmp_path):
    scene = Scene(device="cpu")
    d = make_synthetic_room_dir(tmp_path / "room", dims=(4.0, 2.5, 5.0), seed=1)
    room = load_room(scene, d)
    room = suggest_corners(scene, room)
    return scene, room


def _camera_inside():
    return np.eye(4, dtype=np.float32)


class TestPicking:
    def test_center_pixel_picks_far_wall(self, scene_with_room):
        scene, room = scene_with_room
        r = pick(scene, _camera_inside(), INTR, u=80, v=60)
        assert r.kind in ("plane", "cloud")
        assert r.room_id == room.room_id
        assert 2.0 < r.t < 3.0

    def test_corner_pick_overrides_plane(self, scene_with_room):
        scene, room = scene_with_room
        corner = np.asarray(next(c for _, c in room.corners if c[2] > 0), np.float64)
        fwd = corner / np.linalg.norm(corner)
        up = np.array([0.0, 1.0, 0.0])
        right = np.cross(up, fwd)
        right /= np.linalg.norm(right)
        up2 = np.cross(fwd, right)
        pose = np.eye(4, dtype=np.float32)
        pose[:3, :3] = np.stack([right, up2, fwd]).astype(np.float32)
        r = pick(scene, pose, INTR, u=INTR.cx, v=INTR.cy, corner_radius=0.1)
        assert r.kind == "corner"

    def test_visible_objects_sweep(self, scene_with_room):
        scene, _ = scene_with_room
        objs = visible_objects(scene, _camera_inside(), INTR, step=24)
        kinds = {o.kind for o in objs}
        assert "plane" in kinds or "cloud" in kinds

    def test_empty_scene_picks_none(self):
        r = pick(Scene(device="cpu"), _camera_inside(), INTR, 80, 60)
        assert r.kind == "none"


class TestRender:
    def test_render_writes_image(self, scene_with_room, tmp_path):
        scene, _ = scene_with_room
        img = render_scene(scene, _camera_inside(), INTR, tmp_path / "scene.ppm")
        assert img.shape == (120, 160, 3)
        assert (img.max(axis=-1) > 0.2).mean() > 0.01
        files = list(tmp_path.glob("scene.*"))
        assert files and files[0].stat().st_size > 1000


def _run_reload_script(body: str) -> str:
    """Run ``body`` in a fresh interpreter at the repository root; returns
    its stdout, failing the test on a nonzero exit."""
    script = textwrap.dedent(body)
    proc = subprocess.run([sys.executable, "-c", script], cwd=REPO, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    return proc.stdout


class TestDevloop:
    def test_state_survives_reload(self, tmp_path):
        out = _run_reload_script(f"""
            import sys
            import numpy as np
            import housescan_tpu.utils.bijection as j_bijection
            from housescan_tpu_torch.devloop import get_state, reload_framework, store_state
            from housescan_tpu_torch.rooms import Scene, load_room, suggest_corners
            from housescan_tpu_torch.rooms.types import Room
            from housescan_tpu_torch.testing import make_synthetic_room_dir

            scene = Scene(device="cpu")
            room = suggest_corners(scene, load_room(scene, make_synthetic_room_dir(
                {str(tmp_path / "room")!r}, dims=(4.0, 2.5, 5.0), seed=1)))
            j_biject = j_bijection.biject
            store_state(scene)
            n = reload_framework()
            assert n > 10, n
            restored = get_state()
            assert restored is scene and room.room_id in restored.rooms
            # the port's modules were re-executed, the reference's were not
            assert sys.modules["housescan_tpu_torch.rooms.types"].Room is not Room
            assert sys.modules["housescan_tpu.utils.bijection"].biject is j_biject
            print("reloaded", n)
        """)
        assert "reloaded" in out

    def test_step_after_reload_bit_identical(self):
        _run_reload_script("""
            import importlib
            import torch
            from housescan_tpu_torch.devloop import reload_framework
            from housescan_tpu_torch.kinfu import kinfu_init, kinfu_step
            from housescan_tpu_torch.kinfu.camera import Intrinsics
            from housescan_tpu_torch.kinfu.synthetic import (
                furnished_room, orbit_poses, render_depth_stream)

            intr = Intrinsics(160, 120, 131.25, 131.25, 79.5, 59.5)
            half, boxes = furnished_room()
            poses = orbit_poses(3, radius=0.25, yaw_range=0.1, pitch=0.25)
            frames = render_depth_stream(intr, poses, half, boxes=boxes, device="cpu")
            state = kinfu_init(intr, resolution=128, size_m=3.0, trunc=0.06,
                               init_pose=poses[0], device="cpu")
            state = kinfu_step(state, frames[0], intr)

            def clone(x):  # the step updates the volume and planes in place
                if isinstance(x, torch.Tensor):
                    return x.clone()
                return type(x)(*map(clone, x)) if isinstance(x, tuple) else x

            before = kinfu_step(clone(state), frames[1], intr)
            reload_framework()
            pipeline = importlib.import_module("housescan_tpu_torch.kinfu.pipeline")
            assert pipeline.kinfu_step is not kinfu_step
            after = pipeline.kinfu_step(clone(state), frames[1], intr)
            for name in ("pose", "planes", "model_maps"):
                assert torch.equal(getattr(before, name), getattr(after, name)), name
            assert torch.equal(before.volume.data, after.volume.data)
        """)

    @pytest.mark.parametrize("package", ["housescan_tpu_torch", "housescan_tpu"])
    def test_tracing_and_counts_survive_reload(self, package):
        """Either package's reload re-executes the port's modules in place
        (the reference's prefix test matches this package's name too); the
        metrics, the shared no-op span and the kernel counts stay the
        objects that names imported before it hold, and the step records
        into them after it."""
        _run_reload_script(f"""
            import importlib
            import torch
            from {package}.devloop import reload_framework
            from housescan_tpu_torch.kinfu import kinfu_init, kinfu_step
            from housescan_tpu_torch.kinfu.camera import Intrinsics
            from housescan_tpu_torch.kinfu.synthetic import (
                furnished_room, orbit_poses, render_depth_stream)
            from housescan_tpu_torch.ops import cuda_lib
            from housescan_tpu_torch.utils.metrics import GLOBAL_METRICS, NO_SPAN, Metrics

            counts = (cuda_lib.launch_counts, cuda_lib.plain_counts)
            cuda_lib.plain_counts["chunk_select"] = 5
            reload_framework()
            metrics = importlib.import_module("housescan_tpu_torch.utils.metrics")
            lib = importlib.import_module("housescan_tpu_torch.ops.cuda_lib")
            assert metrics.Metrics is not Metrics  # re-executed ...
            assert metrics.GLOBAL_METRICS is GLOBAL_METRICS and metrics.NO_SPAN is NO_SPAN
            assert (lib.launch_counts, lib.plain_counts) == counts
            assert lib.launch_counts is counts[0] and lib.plain_counts is counts[1]
            assert lib.plain_counts["chunk_select"] == 5
            assert GLOBAL_METRICS.span("step") is NO_SPAN

            pipeline = importlib.import_module("housescan_tpu_torch.kinfu.pipeline")
            intr = Intrinsics(160, 120, 131.25, 131.25, 79.5, 59.5)
            half, boxes = furnished_room()
            poses = orbit_poses(1, radius=0.25, yaw_range=0.1, pitch=0.25)
            frames = render_depth_stream(intr, poses, half, boxes=boxes, device="cpu")
            state = pipeline.kinfu_init(intr, resolution=128, size_m=3.0, trunc=0.06,
                                        init_pose=poses[0], device="cpu")
            GLOBAL_METRICS.enable()
            pipeline.kinfu_step(state, frames[0], intr)
            GLOBAL_METRICS.disable()
            spans = [s.name for s in GLOBAL_METRICS.drain()["spans"]]
            assert spans.count("step") == 1, spans
            assert counts[1]["chunk_select"] == 6
        """)

    def test_schema_change_refuses_restore(self, scene_with_room, monkeypatch):
        import housescan_tpu_torch.devloop.reload as rl
        from housescan_tpu_torch.devloop import get_state, store_state

        scene, _ = scene_with_room
        monkeypatch.setattr(rl, "_STORE", {})
        store_state(scene, slot="s2")
        fp, state = rl._STORE["s2"]
        rl._STORE["s2"] = (fp + "x", state)
        assert get_state("s2") is None

    def test_only_the_port_is_reloaded(self, monkeypatch):
        """The reference's prefix test would also match this package's
        name; the port's list holds its own modules only."""
        import housescan_tpu_torch.devloop.reload as rl

        reloaded = []
        monkeypatch.setattr(rl.importlib, "reload", lambda m: reloaded.append(m.__name__))
        n = rl.reload_framework()
        assert n == len(reloaded) > 10
        assert all(r == "housescan_tpu_torch" or r.startswith("housescan_tpu_torch.")
                   for r in reloaded)
        assert not any(r.startswith("housescan_tpu_torch.devloop") for r in reloaded)


class TestMetrics:
    def test_observe_and_summary(self, tmp_path):
        from housescan_tpu_torch.utils.metrics import Metrics

        m = Metrics(sink_path=tmp_path / "m.jsonl")
        for v in (1.0, 2.0, 3.0):
            m.observe("icp_rmse_mm", v)
        with m.timer("step"):
            pass
        s = m.summary()
        assert s["icp_rmse_mm"]["count"] == 3
        assert s["icp_rmse_mm"]["mean"] == pytest.approx(2.0)
        assert "step" in s
        assert (tmp_path / "m.jsonl").read_text().count("\n") == 4


class TestRansac:
    def test_detects_cuboid_room_planes(self):
        from housescan_tpu_torch.kinfu.ransac import detect_planes

        pts, normals, ds, _ = cuboid_room_points((4.0, 2.5, 5.0), n_per_face=600,
                                                 rng=np.random.default_rng(0))
        det = detect_planes(torch.as_tensor(pts), torch.Generator().manual_seed(0),
                            max_planes=8, min_inliers=300)
        assert int(det.n_planes) == 6
        found_n = det.normals[:6].numpy()
        found_d = det.ds[:6].numpy()
        for n_true, d_true in zip(normals, ds):
            dots = found_n @ n_true
            match = (np.abs(dots) > 0.999) & (np.abs(np.abs(found_d) - abs(d_true)) < 0.01)
            assert match.any(), f"plane {n_true} d={d_true} not found"

    def test_to_dir_round_trips_through_load_room(self, tmp_path):
        from housescan_tpu_torch.io.pcd import save_pcd
        from housescan_tpu_torch.kinfu.ransac import detect_planes_to_dir

        pts, _, _, _ = cuboid_room_points((4.0, 2.5, 5.0), n_per_face=600,
                                          rng=np.random.default_rng(1))
        d = tmp_path / "r"
        d.mkdir()
        save_pcd(d / "cloud_downsampled.pcd", pts)
        det = detect_planes_to_dir(torch.as_tensor(pts), d, min_inliers=300)
        assert int(det.n_planes) == 6
        scene = Scene(device="cpu")
        room = load_room(scene, d)
        assert len(room.planes) == 6
        for p in room.planes:
            err = np.abs(p.bounds @ p.normal - p.d)
            assert err.max() < 0.02


class TestParityWithReference:
    @pytest.fixture
    def scenes(self, tmp_path):
        """The reference's scene and the port's load of its checkpoint."""
        ref = JScene()
        for i in range(2):
            d = make_synthetic_room_dir(tmp_path / f"room{i}", dims=(4.0, 2.5, 5.0), seed=i,
                                        offset=np.array([i * 4.4, 0, 0]))
            j_suggest_corners(ref, j_load_room(ref, d))
        path = j_checkpoint.save_scene(ref, tmp_path / "ref.housescan")
        return j_checkpoint.load_scene(path), load_scene(path, device="cpu")

    def test_render_equals_reference(self, scenes, tmp_path):
        ref, port = scenes
        eye, target = frame_scene(port)
        j_eye, j_target = j_frame_scene(ref)
        np.testing.assert_array_equal(eye, j_eye)
        np.testing.assert_array_equal(target, j_target)
        pose = look_at_pose(eye, target)
        np.testing.assert_array_equal(pose, j_look_at_pose(j_eye, j_target))
        intr = Intrinsics(320, 240, 277.0, 277.0, 160.0, 120.0)
        for p in (pose, _camera_inside()):
            img = render_scene(port, p, intr, tmp_path / "port.ppm", point_px=2)
            j_img = j_render_scene(ref, p, intr, tmp_path / "ref.ppm", point_px=2)
            np.testing.assert_array_equal(img, j_img)
            assert (img.max(axis=-1) > 0.2).mean() > 0.01
        assert (tmp_path / "port.ppm").read_bytes() == (tmp_path / "ref.ppm").read_bytes()

    def test_picks_equal_reference(self, scenes):
        ref, port = scenes
        pose = _camera_inside()
        for v in range(10, 120, 25):
            for u in range(10, 160, 25):
                got = pick(port, pose, INTR, u, v)
                want = j_pick(ref, pose, INTR, u, v)
                assert (got.kind, got.object_id, got.room_id, got.t) == \
                    (want.kind, want.object_id, want.room_id, want.t)
                if want.point is not None:
                    np.testing.assert_array_equal(got.point, want.point)
