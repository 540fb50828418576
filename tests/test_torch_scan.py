"""The port's scan path against the reference: surface points, RANSAC,
marching tetrahedra, scan checkpoints and ``scan_to_room_dir``.

Scene: a 4-frame recorded stream of the furnished-room orbit (160x120)
fused into a 128^3 float32 volume over 3 m, the layout both packages'
scans fuse into (``kinfu_init``'s default). The reference runs as its own
tests run it on the CPU: ``kinfu_step(use_pallas=True, interpret=True)``
with the scan's ``Config()`` ICP settings (its ``angle_threshold`` is left
at its default, which equals the config's: the Pallas path cannot take it
as a traced argument). Its state after frame 2 is the "carried" volume
that both packages' extractors read. Bounds are stated per test.
"""

import dataclasses
import itertools

import pytest

pytest.importorskip("jax")

import jax
import jax.numpy as jnp
import numpy as np
import torch

from housescan_tpu.kinfu import ransac as j_ransac
from housescan_tpu.kinfu.camera import Intrinsics as JIntrinsics
from housescan_tpu.kinfu.marching_cubes import marching_cubes as j_marching_cubes
from housescan_tpu.kinfu.pipeline import kinfu_init as j_init
from housescan_tpu.kinfu.pipeline import kinfu_step as j_step
from housescan_tpu.kinfu.tsdf import TsdfVolume as JTsdfVolume
from housescan_tpu.kinfu.tsdf import extract_surface_points as j_surface_points
from housescan_tpu_torch.capture.replay import load_stream, record_stream
from housescan_tpu_torch.config import Config, TsdfConfig
from housescan_tpu_torch.io.pcd import load_pcd
from housescan_tpu_torch.io.planes_txt import save_planes_txt
from housescan_tpu_torch.io.ply import load_ply, save_ply
from housescan_tpu_torch.geometry.plane import PlaneEq
from housescan_tpu_torch.kinfu import ransac
from housescan_tpu_torch.kinfu.camera import Intrinsics
from housescan_tpu_torch.kinfu.marching_cubes import marching_cubes
from housescan_tpu_torch.kinfu.pipeline import kinfu_init, kinfu_step, state_from_numpy
from housescan_tpu_torch.kinfu.scan import scan_to_room_dir
from housescan_tpu_torch.kinfu.scan_checkpoint import (
    _state_fingerprint,
    load_scan_state,
    save_scan_state,
)
from housescan_tpu_torch.kinfu.synthetic import furnished_room, orbit_poses, render_depth_stream
from housescan_tpu_torch.kinfu.tsdf import TsdfVolume, extract_surface_points
from housescan_tpu_torch.ops.convex_hull import sorted_unique
from hull_cases import CASES as HULL_CASES
from hull_cases import room_cloud

INTR = Intrinsics(width=160, height=120, fx=131.25, fy=131.25, cx=79.5, cy=59.5)
JINTR = JIntrinsics(*INTR)
CFG = Config(tsdf=TsdfConfig(resolution=128, size_m=3.0, trunc_dist=0.06))
N_FRAMES = 4


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def stream_file(tmp_path_factory):
    half, boxes = furnished_room()
    poses = orbit_poses(N_FRAMES, radius=0.25, yaw_range=0.1, pitch=0.25)
    frames = render_depth_stream(INTR, poses, half, boxes, device="cpu")
    path = tmp_path_factory.mktemp("streams") / "scan.npz"
    record_stream(path, frames, INTR, poses=poses)
    return path, poses


def _ref_fields(s):
    return {
        "data": s.volume.data, "origin": s.volume.origin,
        "voxel_size": s.volume.voxel_size, "trunc": s.volume.trunc,
        "planes": s.planes, "pose": s.pose, "model_maps": s.model_maps,
        "model_pose": s.model_pose, "frame_index": s.frame_index,
        "last_rmse": s.last_rmse, "last_corr": s.last_corr,
        "last_tracked": s.last_tracked,
    }


@pytest.fixture(scope="module")
def ref(stream_file):
    """The reference over the recorded stream: per-frame poses, its state
    after frame 2 and after the last frame (numpy), and the final state."""
    torch.set_num_threads(1)
    path, poses = stream_file
    frames = load_stream(path).frames
    st = j_init(JINTR, resolution=128, size_m=3.0, trunc=0.06, init_pose=jnp.asarray(poses[0]))
    traj, after2 = [], None
    for i in range(N_FRAMES):
        st = j_step(st, jnp.asarray(frames[i]), JINTR, iterations=CFG.icp.iterations,
                    dist_threshold=CFG.icp.dist_threshold, max_weight=CFG.tsdf.max_weight,
                    z_min=CFG.camera.z_min, use_pallas=True, interpret=True)
        traj.append(np.array(st.pose))
        if i == 2:
            after2 = {k: np.array(v) for k, v in _ref_fields(st).items()}
    final = {k: np.array(v) for k, v in _ref_fields(st).items()}
    return dict(traj=np.stack(traj), after2=after2, final=final, state=st)


def _volumes(fields):
    """The same volume in both packages."""
    jv = JTsdfVolume(*(jnp.asarray(fields[k]) for k in ("data", "origin", "voxel_size", "trunc")))
    tv = TsdfVolume(*(torch.from_numpy(fields[k].copy())
                      for k in ("data", "origin", "voxel_size", "trunc")))
    return jv, tv


@pytest.fixture(scope="module")
def surface(ref):
    jv, tv = _volumes(ref["after2"])
    pts, count = j_surface_points(jv, max_points=1 << 20)
    want = np.asarray(pts)[: int(count)]
    got = extract_surface_points(tv, max_points=1 << 20).numpy()
    return want, got


# --- surface points -------------------------------------------------------


def test_surface_points_match_reference(surface):
    """Same count, same voxels in the same (raster) order, positions
    within 1e-6 m (both compute the same float32 operations)."""
    want, got = surface
    assert len(want) > 2000
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-6)


def test_surface_points_capacity_keeps_raster_prefix(ref, surface):
    _, tv = _volumes(ref["after2"])
    got = extract_surface_points(tv, max_points=1000).numpy()
    np.testing.assert_array_equal(got, surface[1][:1000])


# --- RANSAC ---------------------------------------------------------------


@pytest.fixture(scope="module")
def cloud(surface):
    return surface[0].astype(np.float32)


def _draws(seed, n, n_hyp=512):
    rng = np.random.default_rng(seed)
    h = n_hyp // 2
    return (rng.integers(0, n, (n_hyp - h, 3)), rng.integers(0, n, (h,)),
            rng.integers(0, n, (h, ransac.K_LOCAL)))


def _ref_with_draws(monkeypatch, draws, fn):
    """Run ``fn`` with the reference's ``jax.random.randint`` answering
    the given index arrays, in its order of calls (triples, anchors,
    candidates); jit is off, so nothing compiled keeps them."""
    seq = itertools.cycle([jnp.asarray(a, jnp.int32) for a in draws])
    monkeypatch.setattr(jax.random, "randint", lambda *a, **k: next(seq))
    with jax.disable_jit():
        return fn()


def _borderline(points, normals, ds, threshold, slack):
    """Per plane, the points whose |distance| lies within ``slack`` of
    the threshold: the only points a last-bit difference can move across
    it."""
    dist = np.abs(points.astype(np.float64) @ normals.T.astype(np.float64) - ds)
    return (np.abs(dist - threshold) <= slack).T


def test_ransac_round_matches_reference_on_given_draws(cloud, monkeypatch):
    """(a) With the same index arrays and points, one round in each
    package. The reference's XLA code contracts multiply-adds (its cross
    products round once where the port's round twice), so equality is
    held up to where that last bit can matter:

      * hypothesis normals within 1e-6 + 5e-7 s, s = |b - a| |c - a| /
        |(b - a) x (c - a)|: each cross component moves by at most ~4 ulp
        of its products (2.4e-7 |b - a| |c - a|), and normalising divides
        by the cross's norm; d within that times |a| sqrt(3);
      * inlier counts: equal up to the points within that normal and d
        error (times |p|) of the 2 cm threshold; the chosen best: equal;
      * refined normal and d within 1e-5 (a 3x3 float32 eigensolve by two
        libraries); final masks equal except points within 2e-5 m of the
        threshold. Each bound is checked to leave nearly all points
        strict."""
    n = len(cloud)
    draws = _draws(1, n)
    jn, jd, jok = (np.asarray(a) for a in _ref_with_draws(
        monkeypatch, draws,
        lambda: j_ransac._hypothesis_planes(jnp.asarray(cloud), jax.random.PRNGKey(0), 512)))
    pts = torch.from_numpy(cloud)
    t_draws = [torch.from_numpy(a) for a in draws]
    tn, td, tok = (a.numpy() for a in ransac.hypothesis_planes(pts, *t_draws))
    np.testing.assert_array_equal(tok, jok)

    # conditioning of each hypothesis, from its three points
    h = 512 // 2
    anchor, cand = draws[1], draws[2]
    a = np.concatenate([cloud[draws[0][:, 0]], cloud[anchor]]).astype(np.float64)
    b_g, c_g = cloud[draws[0][:, 1]], cloud[draws[0][:, 2]]
    cpts = cloud[cand]
    d2 = ((cpts - cloud[anchor][:, None]) ** 2).sum(-1)
    d2 = np.where(d2 < 1e-12, np.inf, d2)
    i1 = np.argmin(d2, 1)
    d2[np.arange(h), i1] = np.inf
    i2 = np.argmin(d2, 1)
    b = np.concatenate([b_g, cpts[np.arange(h), i1]]).astype(np.float64)
    c = np.concatenate([c_g, cpts[np.arange(h), i2]]).astype(np.float64)
    cr = np.linalg.norm(np.cross(b - a, c - a), axis=1)
    s = np.linalg.norm(b - a, axis=1) * np.linalg.norm(c - a, axis=1) / np.maximum(cr, 1e-30)
    tol_n = 1e-6 + 5e-7 * s
    tol_d = tol_n * np.linalg.norm(a, axis=1) * np.sqrt(3)
    ok = jok
    assert (np.abs(tn - jn).max(1) <= tol_n)[ok].all()
    assert (np.abs(td - jd) <= tol_d)[ok].all()

    available = torch.ones(n, dtype=torch.bool)
    r = ransac.ransac_round(pts, available, torch.full((n,), -1, dtype=torch.int32),
                            torch.zeros((), dtype=torch.int32), *t_draws,
                            inlier_threshold=0.02, min_inliers=200)
    # the reference's scoring line on its own hypotheses
    dist = jnp.abs(jnp.matmul(jnp.asarray(jn), jnp.asarray(cloud).T, precision="highest")
                   - jnp.asarray(jd)[:, None])
    j_counts = np.where(jok, np.asarray((dist < 0.02).sum(axis=1)), 0)
    p_max = np.linalg.norm(cloud, axis=1).max()
    slack = np.where(ok, tol_n * p_max + tol_d + 1e-6, 0.0)
    border = np.array([
        _borderline(cloud, jn[i:i + 1], jd[i:i + 1], 0.02, slack[i])[0].sum() for i in range(512)
    ])
    t_counts = r.counts.numpy()
    assert (np.abs(t_counts - j_counts) <= border).all()
    assert border[ok].mean() < 0.01 * n
    assert int(r.best) == int(np.argmax(j_counts))

    det = _ref_with_draws(monkeypatch, draws, lambda: j_ransac.detect_planes(
        jnp.asarray(cloud), jax.random.PRNGKey(0), max_planes=1, n_hypotheses=512,
        inlier_threshold=0.02, min_inliers=200))
    assert bool(r.accept) and int(det.n_planes) == 1
    j_normal, j_d = np.asarray(det.normals)[0], float(np.asarray(det.ds)[0])
    np.testing.assert_allclose(r.plane.normal.numpy(), j_normal, atol=1e-5)
    assert abs(float(r.plane.d) - j_d) <= 1e-5
    edge = _borderline(cloud, j_normal[None], np.array([j_d]), 0.02, 2e-5)[0]
    assert edge.sum() < 0.01 * n
    t_mask, j_mask = r.final_mask.numpy(), np.asarray(det.inlier_of) == 0
    assert (t_mask == j_mask)[~edge].all()
    assert j_mask.sum() > 200


def test_ransac_outcome_matches_reference_with_own_generators(cloud):
    """(b) Each package with its own generator (seed 0) finds the same
    planes: matched one to one, angle <= 0.5 deg, |d| within 5 mm, inlier
    counts within 2%. Why these hold although the hypotheses differ: the
    accepted planes are the scene's large planar surfaces (thousands of
    inliers at a 2 cm threshold), and each is the weighted TLS refit of
    the best hypothesis's inliers, re-collected once. Two hypotheses on
    the same surface share most of their inlier set, so the refits agree
    to the noise of the fit over thousands of points (sub-millimeter,
    hundredths of a degree); the counts of the re-collected sets then
    differ only by points near the 2 cm band's edge."""
    n = len(cloud)
    min_inl = max(int(0.05 * n), 50)
    jdet = j_ransac.detect_planes(jnp.asarray(cloud), jax.random.PRNGKey(0), max_planes=8,
                                  n_hypotheses=512, inlier_threshold=0.02, min_inliers=min_inl)
    tdet = ransac.detect_planes(torch.from_numpy(cloud), max_planes=8, n_hypotheses=512,
                                inlier_threshold=0.02, min_inliers=min_inl)
    k = int(jdet.n_planes)
    assert k >= 2 and int(tdet.n_planes) == k
    jn, jdd, jc = (np.asarray(a)[:k] for a in (jdet.normals, jdet.ds, jdet.inlier_counts))
    tn, tdd, tc = (a[:k].numpy() for a in (tdet.normals, tdet.ds, tdet.inlier_counts))
    unmatched = list(range(k))
    for i in range(k):
        ang = np.degrees(np.arccos(np.clip(np.abs(tn[unmatched] @ jn[i]), -1, 1)))
        j = unmatched[int(np.argmin(ang))]
        assert np.degrees(np.arccos(min(1.0, abs(float(tn[j] @ jn[i]))))) <= 0.5
        assert abs(float(tdd[j]) - float(jdd[i])) <= 0.005
        assert abs(int(tc[j]) - int(jc[i])) <= 0.02 * int(jc[i])
        unmatched.remove(j)


def test_hulls_and_planes_txt_byte_identical(cloud, tmp_path):
    """(c) Given the reference's DetectedPlanes, the port writes the same
    planes.txt and hull files byte for byte."""
    det = j_ransac.detect_planes_to_dir(cloud, tmp_path / "ref", max_planes=8, n_hypotheses=512,
                                        inlier_threshold=0.02,
                                        min_inliers=max(int(0.05 * len(cloud)), 50))
    npl = int(det.n_planes)
    assert npl >= 2
    as_np = j_ransac.DetectedPlanes(*(np.asarray(a) for a in det))
    out = tmp_path / "port"
    out.mkdir()
    save_planes_txt(out / "planes.txt", PlaneEq(as_np.normals[:npl], as_np.ds[:npl]))
    hulls = ransac.plane_hulls(cloud, as_np)
    from housescan_tpu_torch.io.pcd import save_pcd

    for k in range(npl):
        save_pcd(out / f"cloud_plane_hull{k}.pcd", hulls[k])
    for name in ["planes.txt"] + [f"cloud_plane_hull{k}.pcd" for k in range(npl)]:
        assert (out / name).read_bytes() == (tmp_path / "ref" / name).read_bytes(), name


# A few of the shared cases' hulls in full, the signs of their zeros
# included.
HULL_EXACT = {
    "three_collinear": [[0.0, 0.0], [2.0, 2.0]],
    "collinear_runs": [[0.0, 0.0], [10.0, 0.0], [10.0, 10.0], [0.0, 10.0]],
    "diagonal_hull": [[0.0, 8.0], [8.0, 0.0], [16.0, 8.0], [8.0, 16.0]],
    "lone_negative_zeros": [[-1.0, 0.5], [-0.0, -0.0], [3.0, -0.0], [2.0, 3.0], [-0.0, 2.0]],
}


@pytest.mark.parametrize("case", list(HULL_CASES))
def test_python_chain_pinned_on_the_hull_cases(case):
    """The Python chain's hull of each shared case (``tests/hull_cases.py``)
    is the reference's, byte for byte, with its dtype and shape; the card
    tests hold the compiled chain to the Python chain on the same cases,
    and the compiled path's dedupe (``ops/convex_hull.sorted_unique``,
    numpy) gives ``np.unique``'s bytes on them here."""
    x = HULL_CASES[case]()
    got = ransac.convex_hull_2d(x)
    want = j_ransac.convex_hull_2d(x)
    assert got.dtype == want.dtype == np.float64 and got.shape == want.shape
    assert got.tobytes() == want.tobytes()
    if case in HULL_EXACT:
        assert got.tobytes() == np.array(HULL_EXACT[case]).tobytes()
    unique = np.unique(np.asarray(x, np.float64), axis=0)
    pts = sorted_unique(x)
    assert pts.shape == unique.shape and pts.tobytes() == unique.tobytes()


@pytest.fixture(scope="module")
def room_planes():
    cloud = room_cloud()
    return cloud, ransac.detect_planes(torch.from_numpy(cloud), min_inliers=200)


@pytest.mark.parametrize("kind", ["numpy", "cpu_tensor"])
def test_plane_hulls_off_the_card_take_the_python_chain(room_planes, kind, monkeypatch):
    """A numpy or CPU-tensor cloud takes the Python chain, one call a
    plane (``plain_counts``), and never loads the kernel library; traced,
    ``plane_hulls`` counts ``export.hull_points`` once: the unique rows
    the chains took."""
    from housescan_tpu_torch.ops import cuda_lib
    from housescan_tpu_torch.utils.metrics import GLOBAL_METRICS

    def no_library():
        raise AssertionError("the kernel library was loaded")

    took = []
    chain = ransac.monotone_chain
    monkeypatch.setattr(cuda_lib, "load", no_library)
    monkeypatch.setattr(ransac, "monotone_chain", lambda pts: took.append(len(pts)) or chain(pts))
    cloud, det = room_planes
    n_planes = int(det.n_planes)
    assert n_planes == 4
    cuda_lib.reset_counts()
    GLOBAL_METRICS.drain()
    GLOBAL_METRICS.enable()
    try:
        hulls = ransac.plane_hulls(cloud if kind == "numpy" else torch.from_numpy(cloud), det)
    finally:
        GLOBAL_METRICS.disable()
    rec = GLOBAL_METRICS.drain()
    assert cuda_lib.plain_counts["convex_hull"] == n_planes == len(took)
    assert cuda_lib.launch_counts["convex_hull"] == 0
    assert [(c.name, c.value) for c in rec["counters"]] == [("export.hull_points", sum(took))]
    assert len(hulls) == n_planes and all(len(h) >= 4 for h in hulls)


# --- marching tetrahedra --------------------------------------------------


@pytest.fixture(scope="module")
def meshes(ref):
    jv, tv = _volumes(ref["after2"])
    return j_marching_cubes(jv), marching_cubes(tv)


def test_mesh_matches_reference(meshes):
    """Same triangle count and the same soup within 1e-5 m, compared both
    in emission order (the port keeps the reference's) and as sets. The
    reference's XLA code contracts ``(p + 0.5) * voxel + origin`` into a
    fused multiply-add, so vertices differ by an ulp (measured 1.2e-7 m);
    an exact-value lexsort orders near-equal triangles differently under
    such noise, so the set comparison matches each triangle to its
    nearest reference triangle, one to one, within 1e-5 m."""
    from scipy.spatial import cKDTree

    want, got = meshes
    assert len(want.faces) > 5000
    assert got.faces.shape == want.faces.shape
    np.testing.assert_array_equal(got.faces, want.faces)
    np.testing.assert_allclose(got.vertices, want.vertices, atol=1e-5)
    tw, tg = want.vertices.reshape(-1, 9), got.vertices.reshape(-1, 9)
    dist, idx = cKDTree(tw).query(tg)
    assert dist.max() <= 1e-5
    assert len(np.unique(idx)) == len(tw)


def test_mesh_matches_reference_on_bf16_volume(ref):
    """The carried volume rounded to bfloat16 in both packages (the same
    round-to-nearest-even): both widen each slab to float32 before the
    tets, so the soups agree as ``test_mesh_matches_reference``'s do:
    the same faces, vertices within 1e-5 m."""
    fields = dict(ref["after2"])
    jv, tv = _volumes(fields)
    jv = jv._replace(data=jv.data.astype(jnp.bfloat16))
    tv = tv._replace(data=tv.data.to(torch.bfloat16))
    want, got = j_marching_cubes(jv), marching_cubes(tv)
    assert len(want.faces) > 5000
    np.testing.assert_array_equal(got.faces, want.faces)
    np.testing.assert_allclose(got.vertices, want.vertices, atol=1e-5)


def test_mesh_ply_round_trip(meshes, tmp_path):
    got = meshes[1]
    save_ply(tmp_path / "mesh.ply", got)
    back = load_ply(tmp_path / "mesh.ply")
    np.testing.assert_array_equal(back.vertices, got.vertices)
    np.testing.assert_array_equal(back.faces, got.faces)


def test_mesh_slab_size_and_unobserved_volume():
    """Slab size only changes the sweep, not the soup; an unobserved
    volume gives no triangles."""
    res = 48
    idx = (np.arange(res) + 0.5) * (3.0 / res) - 1.5
    gx, gy, gz = np.meshgrid(idx, idx, idx, indexing="ij")
    t = np.clip((0.9 - np.sqrt(gx * gx + gy * gy + gz * gz)) / 0.15, -1, 1)
    ti = np.round(t * 32767).astype(np.int32)
    vol = TsdfVolume(torch.from_numpy((ti << 16) | 1), torch.full((3,), -1.5),
                     torch.tensor(3.0 / res), torch.tensor(0.15))
    m8, m16 = marching_cubes(vol, slab=8), marching_cubes(vol, slab=16)
    assert len(m8.faces) == len(m16.faces) > 600

    def canon(m):
        t = m.vertices.reshape(-1, 9)
        return t[np.lexsort(t.T[::-1])]

    np.testing.assert_array_equal(canon(m8), canon(m16))
    unobserved = vol._replace(data=torch.from_numpy(ti << 16))
    assert len(marching_cubes(unobserved).faces) == 0


def test_mesh_of_a_cpu_volume_runs_the_plain_version():
    """A CPU volume takes the plain version (its counter, not K10's), and
    K10's wrapper refuses a CPU tensor before any launch."""
    from housescan_tpu_torch.kinfu.marching_cubes import marching_cubes_plain
    from housescan_tpu_torch.ops import cuda_lib
    from housescan_tpu_torch.ops.marching_tets import launch_marching_tets

    res = 32
    idx = (np.arange(res) + 0.5) * (2.0 / res) - 1.0
    gx, gy, gz = np.meshgrid(idx, idx, idx, indexing="ij")
    t = np.clip((0.6 - np.sqrt(gx * gx + gy * gy + gz * gz)) / 0.1, -1, 1).astype(np.float32)
    vol = TsdfVolume(torch.stack([torch.from_numpy(t), torch.ones(res, res, res)]),
                     torch.full((3,), -1.0), torch.tensor(2.0 / res), torch.tensor(0.1))
    cuda_lib.reset_counts()
    mesh = marching_cubes(vol)
    assert cuda_lib.plain_counts["marching_tets"] == 1
    assert cuda_lib.launch_counts["marching_tets"] == 0
    plain = marching_cubes_plain(vol)
    assert len(mesh.faces) > 300
    np.testing.assert_array_equal(mesh.vertices, plain.vertices)
    np.testing.assert_array_equal(mesh.faces, plain.faces)
    with pytest.raises(ValueError):
        launch_marching_tets(vol)
    assert cuda_lib.launch_counts["marching_tets"] == 0


# --- scan checkpoints -----------------------------------------------------


def test_port_checkpoint_loads_in_reference(ref, tmp_path):
    from housescan_tpu.kinfu.scan_checkpoint import _state_fingerprint as j_fingerprint
    from housescan_tpu.kinfu.scan_checkpoint import load_scan_state as j_load

    st = state_from_numpy(ref["final"], device="cpu")
    traj = ref["traj"]
    save_scan_state(st, N_FRAMES, INTR, tmp_path / "port.npz", trajectory=traj)
    js, nxt, jtraj = j_load(tmp_path / "port.npz", JINTR)
    assert nxt == N_FRAMES
    assert j_fingerprint(js) == _state_fingerprint(st)
    np.testing.assert_array_equal(jtraj, traj)
    for k, v in _ref_fields(js).items():
        np.testing.assert_array_equal(np.asarray(v), ref["final"][k])


def test_reference_checkpoint_loads_in_port(ref, tmp_path):
    from housescan_tpu.kinfu.scan_checkpoint import _state_fingerprint as j_fingerprint
    from housescan_tpu.kinfu.scan_checkpoint import save_scan_state as j_save

    j_save(ref["state"], N_FRAMES, JINTR, tmp_path / "ref.npz", trajectory=ref["traj"])
    st, nxt, traj = load_scan_state(tmp_path / "ref.npz", INTR, device="cpu")
    assert nxt == N_FRAMES
    assert _state_fingerprint(st) == j_fingerprint(ref["state"])
    np.testing.assert_array_equal(traj, ref["traj"])
    port = {
        "data": st.volume.data, "origin": st.volume.origin, "voxel_size": st.volume.voxel_size,
        "trunc": st.volume.trunc, "planes": st.planes, "pose": st.pose,
        "model_maps": st.model_maps, "model_pose": st.model_pose,
        "frame_index": st.frame_index, "last_rmse": st.last_rmse, "last_corr": st.last_corr,
        "last_tracked": st.last_tracked,
    }
    for k, v in port.items():
        np.testing.assert_array_equal(v.numpy(), ref["final"][k])
        assert v.numpy().dtype == ref["final"][k].dtype


def test_checkpoint_refuses_other_intrinsics(tmp_path):
    st = kinfu_init(INTR, resolution=128, size_m=3.0, trunc=0.06, device="cpu")
    save_scan_state(st, 0, INTR, tmp_path / "s.npz")
    with pytest.raises(ValueError, match="intrinsics"):
        load_scan_state(tmp_path / "s.npz", INTR._replace(width=320), device="cpu")


def test_resume_equivalence(stream_file, tmp_path):
    """Twin of the reference's resume test: a run interrupted after frame
    2, checkpointed and resumed ends in the same pose (1e-6) and the same
    weights as an uninterrupted run."""
    path, poses = stream_file
    frames = [torch.from_numpy(f) for f in load_stream(path).frames]

    def init():
        return kinfu_init(INTR, resolution=128, size_m=3.0, trunc=0.06,
                          init_pose=poses[0], device="cpu")

    full = init()
    for f in frames:
        full = kinfu_step(full, f, INTR, iterations=(2, 2, 2))
    st = init()
    for f in frames[:2]:
        st = kinfu_step(st, f, INTR, iterations=(2, 2, 2))
    save_scan_state(st, 2, INTR, tmp_path / "scan.npz")
    st, nxt, _ = load_scan_state(tmp_path / "scan.npz", INTR, device="cpu")
    assert nxt == 2
    for f in frames[2:]:
        st = kinfu_step(st, f, INTR, iterations=(2, 2, 2))
    np.testing.assert_allclose(st.pose.numpy(), full.pose.numpy(), atol=1e-6)
    assert torch.equal(st.volume.weight, full.volume.weight)


def test_resumed_scan_writes_full_trajectory(stream_file, tmp_path):
    path, poses = stream_file
    stream = load_stream(path)
    kw = dict(config=CFG, init_pose=poses[0], downsample_to=4096, device="cpu")
    full = np.load(scan_to_room_dir(stream, tmp_path / "full", **kw) / "trajectory.npz")["poses"]
    head = dataclasses.replace(stream, frames=stream.frames[:3])
    out = tmp_path / "resumed"
    scan_to_room_dir(head, out, checkpoint_every=2, **kw)
    scan_to_room_dir(stream, out, checkpoint_every=2, resume=True, **kw)
    got = np.load(out / "trajectory.npz")["poses"]
    assert len(got) == N_FRAMES
    np.testing.assert_allclose(got, full, atol=1e-6)


# --- the scan end to end --------------------------------------------------


@pytest.fixture(scope="module")
def scanned(stream_file, tmp_path_factory):
    path, poses = stream_file
    out = tmp_path_factory.mktemp("rooms") / "room_scan"
    scan_to_room_dir(load_stream(path), out, config=CFG, init_pose=poses[0], write_mesh=True,
                     downsample_to=1024, device="cpu")
    return out


def test_scan_writes_reference_layout(scanned):
    names = {p.name for p in scanned.iterdir()}
    assert {"cloud_downsampled.pcd", "cloud_bin.pcd", "planes.txt", "cloud_plane_hull0.pcd",
            "trajectory.npz", "mesh.ply"} <= names
    n_full = len(load_pcd(scanned / "cloud_bin.pcd"))
    assert n_full > 2000
    assert len(load_pcd(scanned / "cloud_downsampled.pcd")) == min(n_full, 1024)
    assert len(load_ply(scanned / "mesh.ply").faces) > 5000


def test_scan_trajectory_matches_reference(scanned, ref):
    """Per frame within the step parity bound of
    ``tests/test_torch_pipeline.py`` (1e-4) summed over the 4 frames:
    4e-4."""
    got = np.load(scanned / "trajectory.npz")["poses"]
    assert got.shape == (N_FRAMES, 4, 4)
    np.testing.assert_allclose(got, ref["traj"], atol=1e-4 * N_FRAMES)


def test_scan_room_loads_in_reference_rooms_stage(scanned):
    from housescan_tpu.rooms import Scene, load_room

    room = load_room(Scene(), scanned)
    assert len(room.cloud.points) > 1000
    assert len(room.planes) >= 2
    center = room.mean()
    for p in room.planes:
        assert float(np.dot(center - p.mean(), p.normal)) > 0


def test_scan_with_known_poses_fuses_at_them(stream_file, tmp_path):
    path, poses = stream_file
    out = scan_to_room_dir(load_stream(path), tmp_path / "known", config=CFG,
                           init_pose=poses[0], downsample_to=4096, device="cpu",
                           known_poses=poses)
    np.testing.assert_array_equal(np.load(out / "trajectory.npz")["poses"],
                                  np.asarray(poses, np.float32))


def test_scan_refuses_untileable_volume(stream_file, tmp_path):
    """The kernel path needs a volume that tiles into 128-voxel chunks,
    so a scan that asks for it at 96^3 is refused (by default such a scan
    takes the XLA path: ``tests/test_torch_xla_loop.py``)."""
    path, _ = stream_file
    cfg = Config(tsdf=TsdfConfig(resolution=96, size_m=3.0, trunc_dist=0.06))
    with pytest.raises(ValueError):
        scan_to_room_dir(load_stream(path), tmp_path / "r", config=cfg, use_pallas=True,
                         device="cpu")
