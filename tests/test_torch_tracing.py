"""The fusion step's spans and counters (``utils/metrics.py``) on the CPU:
a tiny kernel-path step (128^3 volume, 160 x 120 frames, the plain
kernels) traced and untraced.

Tracing changes no arithmetic; every span of the step appears where and
as often as the layers run, nested in its parent and sharing its frame;
the counters equal what the step computed; and with tracing off nothing
is recorded and ``span`` hands out one shared object. The scan's export
(``kinfu/scan.write_room_outputs``) likewise: its spans nest under
``export`` and its counters equal what it wrote.
"""

import numpy as np
import pytest
import torch

from housescan_tpu_torch.kinfu.camera import Intrinsics
from housescan_tpu_torch.kinfu.pipeline import kinfu_init, kinfu_step
from housescan_tpu_torch.kinfu.scan import write_room_outputs
from housescan_tpu_torch.kinfu.tsdf import tsdf_new
from housescan_tpu_torch.kinfu.synthetic import furnished_room, orbit_poses, render_depth_stream
from housescan_tpu_torch.ops.chunk_select import build_worklist, decode_worklist
from housescan_tpu_torch.ops.tsdf_stream import FIELD_SAT, N_QUARTERS
from housescan_tpu_torch.utils.metrics import GLOBAL_METRICS, NO_SPAN, Metrics

QQVGA = Intrinsics(160, 120, 131.25, 131.25, 79.5, 59.5)
N_FRAMES = 3
ITERATIONS = (10, 5, 4)
LEVELS = 3
PER_FRAME = (
    "step", "track", "track.pyramid", "track.model_pyramid", "track.icp", "track.gate",
    "integrate", "integrate.prepass", "integrate.mips", "integrate.free", "integrate.stream",
    "raycast", "raycast.candidates", "raycast.tiles", "raycast.finalize",
)
LEVEL_SPANS = tuple(f"track.icp.level{k}" for k in range(LEVELS))


@pytest.fixture(autouse=True)
def _tracing_off():
    GLOBAL_METRICS.disable()
    GLOBAL_METRICS.drain()
    yield
    GLOBAL_METRICS.disable()
    GLOBAL_METRICS.drain()


def _fresh(poses):
    return kinfu_init(QQVGA, resolution=128, size_m=3.0, trunc=0.06, init_pose=poses[0],
                      device="cpu")


def _step(st, depth):
    return kinfu_step(st, depth, QQVGA, levels=LEVELS, iterations=ITERATIONS)


@pytest.fixture(scope="module")
def runs():
    """The same stream fused untraced and traced: (untraced states,
    traced states, the traced pass's drained record, each traced frame's
    work list recomputed from the state before it)."""
    torch.set_num_threads(2)
    half, boxes = furnished_room()
    poses = orbit_poses(N_FRAMES, radius=0.25, yaw_range=np.pi / 64, pitch=0.25)
    frames = render_depth_stream(QQVGA, poses, half, boxes, device="cpu")

    GLOBAL_METRICS.disable()
    plain = []
    st = _fresh(poses)
    for j in range(N_FRAMES):
        st = _step(st, frames[j])
        plain.append(st._replace(volume=st.volume._replace(data=st.volume.data.clone()),
                                 planes=st.planes.clone()))

    GLOBAL_METRICS.drain()
    GLOBAL_METRICS.enable()
    try:
        traced, listed = [], []
        st = _fresh(poses)
        for j in range(N_FRAMES):
            planes_before = st.planes.clone()
            st = _step(st, frames[j])
            traced.append(st._replace(volume=st.volume._replace(data=st.volume.data.clone()),
                                      planes=st.planes.clone()))
            depth = torch.where(st.last_tracked, frames[j], 0.0)
            vol = st.volume
            sat = planes_before[:, :, :, FIELD_SAT]
            wl, _ = build_worklist(
                depth, st.pose, QQVGA, tuple(vol.dims), vol.voxel_size, vol.origin, vol.trunc,
                sat_quarters=sat[..., :N_QUARTERS].reshape(-1, N_QUARTERS) > 0.5,
                neg_flags=sat[..., N_QUARTERS].reshape(-1) > 0.5, free_split=True)
            listed.append(len(decode_worklist(wl)))
    finally:
        GLOBAL_METRICS.disable()
    return plain, traced, GLOBAL_METRICS.drain(), listed


def test_tracing_changes_no_arithmetic(runs):
    plain, traced, _, _ = runs
    for a, b in zip(plain, traced):
        for name in a._fields:
            if name == "volume":
                assert torch.equal(a.volume.data, b.volume.data)
            else:
                assert torch.equal(getattr(a, name), getattr(b, name)), name


def _by_frame(spans):
    frames = {}
    for sp in spans:
        frames.setdefault(sp.frame, []).append(sp)
    return frames


def test_every_span_once_a_frame_and_once_a_level(runs):
    _, _, rec, _ = runs
    frames = _by_frame(rec["spans"])
    inits = [f for f, sps in frames.items() if [s.name for s in sps] == ["init"]]
    steps = [f for f, sps in frames.items() if sps[0].name == "step"]
    assert len(inits) == 1 and len(steps) == N_FRAMES and len(frames) == N_FRAMES + 1
    for f in steps:
        names = [s.name for s in frames[f]]
        assert sorted(names) == sorted(PER_FRAME + LEVEL_SPANS), names
        # levels run coarse to fine
        assert [n for n in names if n.startswith("track.icp.level")] == list(LEVEL_SPANS[::-1])


def test_children_lie_inside_their_parents_and_share_the_frame(runs):
    _, _, rec, _ = runs
    spans = rec["spans"]
    parent_of = {"step": None, "track": "step", "integrate": "step", "raycast": "step",
                 "init": None}
    for sp in spans:
        assert sp.start_ns <= sp.end_ns
        if sp.parent < 0:
            assert parent_of[sp.name] is None
            continue
        up = spans[sp.parent]
        want = parent_of.get(sp.name, sp.name.rsplit(".", 1)[0])
        assert up.name == want, (sp.name, up.name)
        assert up.start_ns <= sp.start_ns and sp.end_ns <= up.end_ns
        assert up.frame == sp.frame


def test_counters_equal_the_steps_own_work(runs):
    _, traced, rec, listed = runs
    steps = sorted({s.frame for s in rec["spans"] if s.name == "step"})
    got = {}
    for c in rec["counters"]:
        got.setdefault(c.frame, {})[c.name] = c.value
    assert sorted(got) == steps
    for j, f in enumerate(steps):
        vals = got[f]
        assert vals["integrate.listed_chunks"] == listed[j]
        assert vals["integrate.free_superblocks"] >= 1
        for k in range(LEVELS):
            assert 1 <= vals[f"icp.level{k}.iterations"] <= ITERATIONS[k]
            assert 0 <= vals[f"icp.level{k}.corr"] <= vals[f"icp.level{k}.visible"] or j == 0
        # the step reports the finest level that had correspondences
        if j > 0:
            finest = next(vals[f"icp.level{k}.corr"] for k in range(LEVELS)
                          if vals[f"icp.level{k}.corr"] > 0)
            assert finest == int(traced[j].last_corr)


def test_tracing_off_records_nothing_and_shares_one_span():
    assert not GLOBAL_METRICS.tracing
    assert GLOBAL_METRICS.span("step") is GLOBAL_METRICS.span("raycast") is NO_SPAN
    half, boxes = furnished_room()
    poses = orbit_poses(2, radius=0.25, yaw_range=np.pi / 64, pitch=0.25)
    frames = render_depth_stream(QQVGA, poses, half, boxes, device="cpu")
    st = _fresh(poses)
    for j in range(2):
        st = _step(st, frames[j])
    GLOBAL_METRICS.count("integrate.listed_chunks", torch.ones(1))
    assert GLOBAL_METRICS.drain() == {"spans": [], "counters": []}


def test_drain_reads_tensors_and_numbers_and_forgets():
    m = Metrics()
    m.enable()
    with m.span("step"):
        with m.span("track"):
            m.count("a", torch.tensor([7], dtype=torch.int32))
        m.count("b", torch.tensor(2.5))
        m.count("c", 3)
    with m.span("step"):
        pass
    rec = m.drain()
    assert [(c.name, c.value) for c in rec["counters"]] == [("a", 7), ("b", 2.5), ("c", 3)]
    assert [(s.name, s.parent, s.frame) for s in rec["spans"]] == [
        ("step", -1, 1), ("track", 0, 1), ("step", -1, 2)]
    assert m.drain() == {"spans": [], "counters": []}
    with m.span("open"):
        with pytest.raises(RuntimeError):
            m.drain()


def _box_volume():
    """A 64^3 volume over 1 m holding the inside of a 0.6 m box, every
    voxel observed: six walls for RANSAC, a closed surface for the mesh."""
    vol = tsdf_new(64, 1.0, 0.03, device="cpu")
    c = (torch.arange(64, dtype=torch.float32) + 0.5) / 64 - 0.5
    x, y, z = torch.meshgrid(c, c, c, indexing="ij")
    inside = 0.3 - torch.maximum(torch.maximum(x.abs(), y.abs()), z.abs())
    vol.data[0] = torch.clamp(inside / 0.03, -1.0, 1.0)
    vol.data[1] = 1.0
    return vol


@pytest.mark.parametrize("traced", [True, False], ids=["traced", "untraced"])
def test_export_spans_nest_and_counters_equal_what_it_wrote(tmp_path, traced):
    vol = _box_volume()
    if traced:
        GLOBAL_METRICS.enable()
    room = write_room_outputs(vol, [np.eye(4, dtype=np.float32)], tmp_path / "room",
                              max_points_full=20000, downsample_to=4000, write_mesh=True)
    GLOBAL_METRICS.disable()
    rec = GLOBAL_METRICS.drain()
    if not traced:
        assert rec == {"spans": [], "counters": []}
        return
    spans = rec["spans"]
    assert spans[0].name == "export" and spans[0].parent == -1
    assert {s.name for s in spans[1:]} == {"export.surface", "export.ransac", "export.mesh",
                                           "export.writes", "export.ransac.hulls"}
    assert [s.name for s in spans].count("export.writes") == 3
    names = [s.name for s in spans]
    assert names.count("export.ransac.hulls") == 1
    for s in spans[1:]:
        outer = spans[s.parent]
        assert s.frame == spans[0].frame
        assert outer.name == ("export.ransac" if s.name == "export.ransac.hulls" else "export")
        assert outer.start_ns <= s.start_ns <= s.end_ns <= outer.end_ns
    counts = {c.name: c.value for c in rec["counters"]}
    assert 0 < counts.pop("export.hull_points") <= 4000  # unique projected inliers
    n_points = int((room / "cloud_bin.pcd").read_bytes().split(b"POINTS ")[1].split()[0])
    n_planes = len((room / "planes.txt").read_text().split()) // 4
    n_faces = int((room / "mesh.ply").read_bytes().split(b"element face ")[1].split()[0])
    assert counts == {"export.surface_points": n_points, "export.planes": n_planes,
                      "export.mesh_triangles": n_faces}
    assert n_points > 4000 and n_planes >= 4 and n_faces > 1000
