"""The port's scene checkpoints and metrics: twins of tests/test_checkpoint.py
(round trip, migrations, ID rebasing, fingerprint, free planes) and of
test_capture_scan.py's TestAsyncCheckpoint, then parity with the JAX
package: a scene written by either package loads in the other with equal
arrays (exact: the same .npy bytes), and both compute one schema
fingerprint."""

import json
import zipfile

import pytest

pytest.importorskip("jax")

import numpy as np
import torch

from housescan_tpu.io import checkpoint as j_checkpoint
from housescan_tpu.rooms import Scene as JScene
from housescan_tpu.rooms import load_room as j_load_room
from housescan_tpu.rooms import suggest_corners as j_suggest_corners
from housescan_tpu.rooms.types import Plane as JPlane
from housescan_tpu.rooms.types import WallRelation as JWallRelation
from housescan_tpu_torch.io.checkpoint import (
    CURRENT_VERSION,
    load_scene,
    save_scene,
    save_scene_async,
    schema_fingerprint,
)
from housescan_tpu_torch.rooms import Scene, WallRelation, load_room, suggest_corners
from housescan_tpu_torch.rooms.types import Axis, Plane
from housescan_tpu_torch.testing import make_synthetic_room_dir
from housescan_tpu_torch.utils.metrics import device_trace, tsdf_occupancy


def _populate(scene, tmp_path, load, suggest, relation):
    for i in range(2):
        d = make_synthetic_room_dir(tmp_path / f"room{i}", seed=i, offset=np.array([i * 5.0, 0, 0]))
        suggest(scene, load(scene, d))
    rooms = list(scene.rooms.values())
    scene.connected_walls.append(
        (Axis.X, relation.opposite(0.12), rooms[0].planes[0].plane_id, rooms[1].planes[0].plane_id)
    )
    return scene


@pytest.fixture
def populated_scene(tmp_path):
    return _populate(Scene(device="cpu"), tmp_path, load_room, suggest_corners, WallRelation)


def _rewrite_version(path, mutate):
    with zipfile.ZipFile(path) as zf:
        manifest = json.loads(zf.read("manifest.json"))
        entries = {n: zf.read(n) for n in zf.namelist() if n != "manifest.json"}
    manifest = mutate(manifest)
    with zipfile.ZipFile(path, "w") as zf:
        zf.writestr("manifest.json", json.dumps(manifest))
        for n, blob in entries.items():
            zf.writestr(n, blob)


def _with_free_plane(scene, plane_cls):
    p = plane_cls(
        plane_id=scene.gen_id(),
        normal=np.array([0.0, 0.6, 0.8], np.float32),
        d=-0.35,
        color=(0.1, 0.9, 0.4),
        bounds=np.array([[0, 0, 0], [1, 0, 0], [1, 1, 1]], np.float32),
    )
    scene.planes[p.plane_id] = p
    return p


class TestRoundTrip:
    def test_save_load_identity(self, populated_scene, tmp_path):
        path = save_scene(populated_scene, tmp_path / "s.housescan")
        loaded = load_scene(path, device="cpu")
        assert loaded.device == "cpu"
        assert set(loaded.rooms) == set(populated_scene.rooms)
        assert loaded.next_id == populated_scene.next_id
        for rid, room in populated_scene.rooms.items():
            lr = loaded.rooms[rid]
            np.testing.assert_array_equal(lr.cloud.points, room.cloud.points)
            np.testing.assert_array_equal(lr.proj, room.proj)
            assert len(lr.planes) == len(room.planes)
            assert [i for i, _ in lr.corners] == [i for i, _ in room.corners]
            assert lr.name == room.name
        axis, rel, p1, p2 = loaded.connected_walls[0]
        assert axis == Axis.X and rel.kind == "opposite"
        assert rel.thickness == pytest.approx(0.12)

    def test_load_into_rebases_ids(self, populated_scene, tmp_path):
        path = save_scene(populated_scene, tmp_path / "s.housescan")
        live = Scene(device="meta")
        live.next_id = populated_scene.next_id
        merged = load_scene(path, into=live)
        assert merged is live and merged.device == "meta"  # into keeps its device
        all_ids = [i for room in merged.rooms.values() for i in room.get_ids()]
        assert min(all_ids) >= populated_scene.next_id
        assert merged.next_id > max(all_ids)
        _, _, p1, p2 = merged.connected_walls[0]
        plane_ids = {p.plane_id for room in merged.rooms.values() for p in room.planes}
        assert p1 in plane_ids and p2 in plane_ids


class TestMigrations:
    def test_v1_rooms_only_loads(self, populated_scene, tmp_path):
        path = save_scene(populated_scene, tmp_path / "v1.housescan")

        def to_v1(m):
            m.pop("connected_walls")
            m.pop("settings")
            m["schema_version"] = 1
            return m

        _rewrite_version(path, to_v1)
        loaded = load_scene(path, device="cpu")
        assert len(loaded.rooms) == 2
        assert loaded.connected_walls == []

    def test_v2_wall_thickness_default(self, populated_scene, tmp_path):
        path = save_scene(populated_scene, tmp_path / "v2.housescan")

        def to_v2(m):
            m["connected_walls"] = [[w[0], w[1], w[3], w[4]] for w in m["connected_walls"]]
            m.pop("settings")
            m["schema_version"] = 2
            return m

        _rewrite_version(path, to_v2)
        loaded = load_scene(path, device="cpu")
        assert loaded.connected_walls[0][1].thickness == pytest.approx(0.1)

    def test_future_version_rejected(self, populated_scene, tmp_path):
        path = save_scene(populated_scene, tmp_path / "vf.housescan")

        def to_future(m):
            m["schema_version"] = CURRENT_VERSION + 1
            return m

        _rewrite_version(path, to_future)
        with pytest.raises(ValueError, match="newer than supported"):
            load_scene(path, device="cpu")


class TestFingerprint:
    def test_fingerprint_stable(self):
        assert schema_fingerprint() == schema_fingerprint()

    def test_fingerprint_in_manifest(self, populated_scene, tmp_path):
        path = save_scene(populated_scene, tmp_path / "f.housescan")
        with zipfile.ZipFile(path) as zf:
            manifest = json.loads(zf.read("manifest.json"))
        assert manifest["schema_fingerprint"] == schema_fingerprint()


class TestFreePlanes:
    def test_round_trip(self, populated_scene, tmp_path):
        p = _with_free_plane(populated_scene, Plane)
        path = save_scene(populated_scene, tmp_path / "fp.housescan")
        loaded = load_scene(path, device="cpu")
        assert set(loaded.planes) == {p.plane_id}
        lp = loaded.planes[p.plane_id]
        np.testing.assert_allclose(lp.normal, p.normal)
        assert lp.d == pytest.approx(p.d)
        assert lp.color == pytest.approx(p.color)
        np.testing.assert_array_equal(lp.bounds, p.bounds)

    def test_merge_rebases_free_plane_ids(self, populated_scene, tmp_path):
        p = _with_free_plane(populated_scene, Plane)
        path = save_scene(populated_scene, tmp_path / "fp.housescan")
        into = load_scene(path, device="cpu")
        bump = into.next_id
        merged = load_scene(path, into=into)
        assert len(merged.planes) == 2
        assert set(merged.planes) == {p.plane_id, p.plane_id + bump}
        assert merged.next_id > p.plane_id + bump

    def test_v3_without_free_planes_loads(self, populated_scene, tmp_path):
        _with_free_plane(populated_scene, Plane)
        path = save_scene(populated_scene, tmp_path / "v3.housescan")

        def to_v3(m):
            m.pop("free_planes")
            m["schema_version"] = 3
            return m

        _rewrite_version(path, to_v3)
        loaded = load_scene(path, device="cpu")
        assert loaded.planes == {}
        assert len(loaded.rooms) == 2


class TestAsyncCheckpoint:
    def test_async_save_is_loadable(self, tmp_path):
        scene = Scene(device="cpu")
        load_room(scene, make_synthetic_room_dir(tmp_path / "r", seed=5))
        t = save_scene_async(scene, tmp_path / "async.housescan")
        t.join(timeout=30)
        assert not t.is_alive()
        loaded = load_scene(tmp_path / "async.housescan", device="cpu")
        assert set(loaded.rooms) == set(scene.rooms)


def _assert_scenes_equal(a, b):
    """Equal arrays (exact), IDs, names, walls and free planes."""
    assert a.next_id == b.next_id
    assert sorted(a.rooms) == sorted(b.rooms)
    for rid in a.rooms:
        ra, rb = a.rooms[rid], b.rooms[rid]
        np.testing.assert_array_equal(ra.cloud.points, rb.cloud.points)
        np.testing.assert_array_equal(ra.proj, rb.proj)
        assert ra.name == rb.name and ra.cloud.cloud_id == rb.cloud.cloud_id
        assert [p.plane_id for p in ra.planes] == [p.plane_id for p in rb.planes]
        for pa, pb in zip(ra.planes, rb.planes):
            np.testing.assert_array_equal(pa.normal, pb.normal)
            np.testing.assert_array_equal(pa.bounds, pb.bounds)
            assert pa.d == pb.d
        for ca, cb in ((ra.corners, rb.corners), (ra.suggested_corners, rb.suggested_corners)):
            assert [i for i, _ in ca] == [i for i, _ in cb]
            for (_, xa), (_, xb) in zip(ca, cb):
                np.testing.assert_array_equal(xa, xb)
    assert [(int(ax), rel.kind, rel.thickness, p1, p2) for ax, rel, p1, p2 in a.connected_walls] == \
        [(int(ax), rel.kind, rel.thickness, p1, p2) for ax, rel, p1, p2 in b.connected_walls]
    assert sorted(a.planes) == sorted(b.planes)
    for pid in a.planes:
        np.testing.assert_array_equal(a.planes[pid].bounds, b.planes[pid].bounds)
        np.testing.assert_array_equal(a.planes[pid].normal, b.planes[pid].normal)


class TestParityWithReference:
    def test_schema_fingerprints_equal(self):
        assert schema_fingerprint() == j_checkpoint.schema_fingerprint()

    def test_reference_scene_loads_in_port(self, tmp_path):
        ref = _populate(JScene(), tmp_path / "j", j_load_room, j_suggest_corners, JWallRelation)
        _with_free_plane(ref, JPlane)
        path = j_checkpoint.save_scene(ref, tmp_path / "ref.housescan")
        _assert_scenes_equal(load_scene(path, device="cpu"), j_checkpoint.load_scene(path))

    def test_port_scene_loads_in_reference(self, populated_scene, tmp_path):
        _with_free_plane(populated_scene, Plane)
        path = save_scene(populated_scene, tmp_path / "port.housescan")
        _assert_scenes_equal(j_checkpoint.load_scene(path), populated_scene)
        _assert_scenes_equal(j_checkpoint.load_scene(path), load_scene(path, device="cpu"))


class TestMetrics:
    @pytest.mark.parametrize("dtype", [torch.int32, torch.float32, torch.bfloat16])
    def test_tsdf_occupancy_any_layout(self, dtype):
        from housescan_tpu_torch.kinfu.tsdf import tsdf_new

        vol = tsdf_new(16, 1.0, 0.1, dtype=dtype, device="cpu")
        assert tsdf_occupancy(vol) == 0.0
        w = torch.zeros(16, 16, 16)
        w[:4] = 1.0
        vol = vol.replace_grids(weight=w)
        assert tsdf_occupancy(vol) == pytest.approx(0.25)

    def test_device_trace_writes_chrome_trace(self, tmp_path):
        with device_trace(tmp_path / "trace") as prof:
            torch.ones(64).cumsum(0)
        trace = json.loads((tmp_path / "trace" / "trace.json").read_text())
        assert "traceEvents" in trace
        assert prof.key_averages() is not None
