"""The port's mesh, collectives and sharded fusion against the reference.

The port's mesh has one controller (``housescan_tpu_torch/parallel/
mesh.py``); here it lays 8 shards on the CPU (``devices=["cpu"] * 8``),
as the JAX package's tests lay 8 virtual CPU devices. Twins of
``tests/test_parallel.py`` (same scenes, same bounds), then:

  * the collectives and the halo exchange against numpy: exact;
  * ``single <-> sharded`` round trips: exact, on every layout;
  * an 8-slab 128^3 kernel-path orbit, teacher-forced for 3 frames:
    bit-identical to the port's single-device step (pose, volume,
    planes, model vertices, valid mask; normals within the reference's
    bound: < 5e-3, under 1% of pixels over 1e-4), and within the
    pipeline parity's bounds of the JAX package's sharded step (Pallas
    in interpret mode): poses 1e-4, weights identical, the packed tsdf
    within one quantization step on >= 99.9% of observed voxels, valid
    masks on >= 99%;
  * the XLA path, teacher-forced for 3 frames, against the JAX package's
    sharded XLA step (bounds in its test);
  * the 2 x 4 re-fuse and the batched cuboid fit, exact against the
    single-device fusions and the unsplit batch.
"""

import numpy as np
import pytest
import torch

from housescan_tpu_torch.kinfu import maps as mp
from housescan_tpu_torch.kinfu.camera import Intrinsics
from housescan_tpu_torch.kinfu.pipeline import kinfu_init, kinfu_step
from housescan_tpu_torch.kinfu.synthetic import furnished_room, orbit_poses, render_depth_stream
from housescan_tpu_torch.kinfu.tsdf import tsdf_integrate, tsdf_new
from housescan_tpu_torch.parallel import (
    fit_cuboids_sharded,
    make_mesh,
    make_mesh2d,
    make_sharded_step,
    refuse_rooms_2d,
    sharded_kinfu_init,
)
from housescan_tpu_torch.parallel.mesh import pmax, pmin, ppermute, psum
from housescan_tpu_torch.parallel.sharded import (
    _halo_extend_x,
    sharded_state_from_single,
    single_state_from_sharded,
)
from housescan_tpu_torch.solvers.cuboid_fit import cuboid_from_params, fit_cuboid_batch

INTR = Intrinsics(width=160, height=120, fx=131.25, fy=131.25, cx=79.5, cy=59.5)


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def mesh():
    return make_mesh(8, devices=["cpu"] * 8)


@pytest.fixture(scope="module")
def stream():
    half, boxes = furnished_room()
    poses = orbit_poses(3, radius=0.25, yaw_range=0.08, pitch=0.25)
    frames = render_depth_stream(INTR, poses, half, boxes=boxes, device="cpu")
    return poses, frames


# --- the mesh and the collectives ---------------------------------------------


def test_make_mesh_takes_devices_and_raises_on_too_few():
    m = make_mesh(4, devices=["cpu"] * 8)
    assert m.size == 4 and m.shape == (4,) and m.axis_names == ("shard",)
    assert all(d == torch.device("cpu") for d in m.devices)
    m2 = make_mesh2d(2, 4, devices=["cpu"] * 8)
    assert m2.shape == (2, 4) and m2.row(1).size == 4
    with pytest.raises(ValueError):
        make_mesh(9, devices=["cpu"] * 8)
    with pytest.raises(ValueError):
        make_mesh2d(3, 3, devices=["cpu"] * 8)
    if torch.cuda.device_count() < 64:
        with pytest.raises(ValueError):  # the default: visible CUDA devices only
            make_mesh(64)


def test_collectives_match_numpy():
    rng = np.random.default_rng(0)
    xs = [rng.normal(size=(5, 7)).astype(np.float32) for _ in range(8)]
    ts = [torch.from_numpy(x) for x in xs]
    want_sum = xs[0].copy()
    for x in xs[1:]:
        want_sum = want_sum + x  # shard order, float32
    for got in psum(ts):
        np.testing.assert_array_equal(got.numpy(), want_sum)
    for got in pmin(ts):
        np.testing.assert_array_equal(got.numpy(), np.min(xs, axis=0))
    for got in pmax(ts):
        np.testing.assert_array_equal(got.numpy(), np.max(xs, axis=0))
    assert len(psum(ts, [torch.device("cpu")])) == 1
    ring = [(i, (i + 1) % 8) for i in range(8)]
    got = ppermute(ts, ring)
    for i in range(8):
        np.testing.assert_array_equal(got[i].numpy(), xs[(i - 1) % 8])
    assert ppermute(ts, [(0, 3)])[5] is None


def test_halo_extend_matches_numpy():
    """Each slab gains ``halo`` X-planes of its neighbours on both sides;
    the volume's two outer halos are unobserved (weight 0, tsdf +1)."""
    rng = np.random.default_rng(1)
    t = rng.uniform(-1, 1, (32, 6, 5)).astype(np.float32)
    w = rng.integers(0, 9, (32, 6, 5)).astype(np.float32)
    n, halo = 4, 2
    ext_t, ext_w = _halo_extend_x([torch.from_numpy(c) for c in np.split(t, n)],
                                  [torch.from_numpy(c) for c in np.split(w, n)], halo)
    tp = np.concatenate([np.ones((halo, 6, 5), np.float32), t, np.ones((halo, 6, 5), np.float32)])
    wp = np.concatenate([np.zeros((halo, 6, 5), np.float32), w, np.zeros((halo, 6, 5), np.float32)])
    for i in range(n):
        lo = i * 8
        np.testing.assert_array_equal(ext_t[i].numpy(), tp[lo:lo + 8 + 2 * halo])
        np.testing.assert_array_equal(ext_w[i].numpy(), wp[lo:lo + 8 + 2 * halo])


@pytest.mark.parametrize("dtype", [torch.int32, torch.float32, torch.bfloat16],
                         ids=["packed", "float32", "bfloat16"])
def test_single_sharded_round_trip_exact(mesh, stream, dtype):
    """A single-device state cut into 8 slabs and gathered back is the
    same state, on every layout; each float slab is a contiguous
    (2, X/8, Y, Z) tensor of its own."""
    poses, frames = stream
    st = kinfu_init(INTR, resolution=128, size_m=3.0, trunc=0.06, init_pose=poses[0],
                    dtype=dtype, device="cpu")
    st = kinfu_step(st, frames[0], INTR)
    sh = sharded_state_from_single(mesh, st, use_pallas=True)
    slab = sh.volume.slabs[0]
    assert slab.is_contiguous() and slab.shape[-3:] == (16, 128, 128)
    assert slab.data_ptr() != st.volume.data.data_ptr()
    back = single_state_from_sharded(sh)
    for a, b in ((back.volume.data, st.volume.data), (back.planes, st.planes),
                 (back.pose, st.pose), (back.model_maps, st.model_maps),
                 (back.frame_index, st.frame_index), (back.volume.origin, st.volume.origin)):
        assert torch.equal(a, b)
    xla = sharded_state_from_single(mesh, st, use_pallas=False)
    assert torch.equal(single_state_from_sharded(xla).volume.data, st.volume.data)


# --- twins of tests/test_parallel.py ------------------------------------------


def test_sharded_integrate_matches_single_device(mesh, stream):
    poses, frames = stream
    state = sharded_kinfu_init(mesh, INTR, resolution=64, size_m=3.0, trunc=0.1,
                               init_pose=poses[0])
    step = make_sharded_step(mesh, INTR, max_raycast_steps=48)
    state = step(state, frames[0])
    ref = tsdf_integrate(tsdf_new(64, 3.0, 0.1, device="cpu"), frames[0],
                         torch.from_numpy(poses[0]), INTR)
    got = state.volume.gather()
    # the reference holds its slab-local origins to 1e-5; the port's slabs
    # take the whole volume's voxel centres: bit-identical
    np.testing.assert_array_equal(got.tsdf.numpy(), ref.tsdf.numpy())
    np.testing.assert_array_equal(got.weight.numpy(), ref.weight.numpy())


def test_xla_sharded_free_running_orbit(mesh):
    """20 free-running frames on the XLA path (the route of volumes that do
    not tile): the final pose within half a voxel (a frozen pose is ~90
    mm off), the model maps mostly valid."""
    half, boxes = furnished_room()
    n = 20
    poses = orbit_poses(n + 1, radius=0.25, yaw_range=0.02 * n, pitch=0.25)
    frames = render_depth_stream(INTR, poses, half, boxes=boxes, device="cpu")
    state = sharded_kinfu_init(mesh, INTR, resolution=64, size_m=3.0, trunc=0.1,
                               init_pose=poses[0])
    step = make_sharded_step(mesh, INTR, max_raycast_steps=48)
    for i in range(n):
        state = step(state, frames[i])
    err = float(np.linalg.norm(state.pose[3, :3].numpy() - poses[n - 1][3, :3]))
    voxel = 3.0 / 64
    assert err < 0.5 * voxel, f"XLA-sharded free-running err {err * 1000:.1f} mm"
    assert float(state.model_maps[mp.MD_VALID].mean()) > 0.5


def test_sharded_forced_pose(mesh, stream):
    """Known poses on the sharded step: each frame fuses at its pose, bit
    for bit, without tracking."""
    poses, frames = stream
    state = sharded_kinfu_init(mesh, INTR, resolution=64, size_m=3.0, trunc=0.1,
                               init_pose=poses[0])
    step = make_sharded_step(mesh, INTR, max_raycast_steps=48)
    for k in range(3):
        state = step(state, frames[k], forced_pose=poses[k])
    np.testing.assert_array_equal(state.pose.numpy(), poses[2].astype(np.float32))
    assert float(state.model_maps[mp.MD_VALID].mean()) > 0.5


def test_volume_is_actually_sharded(mesh):
    state = sharded_kinfu_init(mesh, INTR, resolution=64)
    assert {tuple(s.shape) for s in state.volume.slabs} == {(2, 8, 64, 64)}
    assert len({s.data_ptr() for s in state.volume.slabs}) == 8
    packed = sharded_kinfu_init(mesh, INTR, resolution=128, use_pallas=True)
    assert {tuple(s.shape) for s in packed.volume.slabs} == {(16, 128, 128)}
    assert {tuple(p.shape) for p in packed.planes} == {(2, 16, 1, 16, 16)}


@pytest.fixture(scope="module")
def kernel_orbit(mesh):
    """The 8-slab kernel-path step at 128^3, teacher-forced: before each of
    3 frames the single-device state is cut into slabs, then both steps
    run; and the JAX package's sharded step from the reference's own
    single-device state, alike."""
    torch.set_num_threads(1)
    half, boxes = furnished_room()
    poses = orbit_poses(4, radius=0.25, yaw_range=0.06, pitch=0.25)
    frames = render_depth_stream(INTR, poses, half, boxes=boxes, device="cpu")
    step = make_sharded_step(mesh, INTR, iterations=(10, 5, 4), use_pallas=True)
    ref = kinfu_init(INTR, resolution=128, size_m=3.0, trunc=0.06, init_pose=poses[0],
                     dtype=torch.int32, device="cpu")
    records = []
    for k in range(3):
        sh = single_state_from_sharded(step(sharded_state_from_single(mesh, ref, True),
                                            frames[k]))
        ref = kinfu_step(ref, frames[k], INTR)  # updates ref's volume in place: compare now
        dn = (sh.model_maps[mp.MD_N] - ref.model_maps[mp.MD_N]).abs()
        records.append(dict(
            pose=torch.equal(sh.pose, ref.pose),
            volume=torch.equal(sh.volume.data, ref.volume.data),
            planes=torch.equal(sh.planes, ref.planes),
            vertices=torch.equal(sh.model_maps[mp.MD_V], ref.model_maps[mp.MD_V]),
            valid=torch.equal(sh.model_maps[mp.MD_VALID], ref.model_maps[mp.MD_VALID]),
            dn_max=float(dn.max()), n_flip=int((dn.amax(0) > 1e-4).sum()), px=dn[0].numel(),
        ))
    return poses, frames, records


def test_kernel_path_sharded_bit_identical_to_single(kernel_orbit):
    _, _, records = kernel_orbit
    for k, r in enumerate(records):
        for what in ("pose", "volume", "planes", "vertices", "valid"):
            assert r[what], f"frame {k}: {what} not bit-identical"
        assert r["dn_max"] < 5e-3 and r["n_flip"] < r["px"] // 100, (k, r)


def test_kernel_path_sharded_matches_reference(kernel_orbit):
    """The JAX package's ``make_sharded_step(use_pallas=True,
    interpret=True)`` on its 8-device CPU mesh, teacher-forced from its
    own single-device state, against the port's sharded step, frame by
    frame from the same carried state."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    from housescan_tpu.kinfu.camera import Intrinsics as JIntrinsics
    from housescan_tpu.kinfu.pipeline import kinfu_init as j_init
    from housescan_tpu.kinfu.pipeline import kinfu_step as j_step
    from housescan_tpu.parallel import make_mesh as j_make_mesh
    from housescan_tpu.parallel import make_sharded_step as j_make_step
    from housescan_tpu.parallel.sharded import sharded_state_from_single as j_scatter
    from housescan_tpu_torch.kinfu.pipeline import state_from_numpy

    if len(jax.devices()) < 8:
        pytest.skip("the reference's sharded step needs its 8-device CPU mesh")
    poses, frames, _ = kernel_orbit
    jintr = JIntrinsics(*INTR)
    jmesh = j_make_mesh(8)
    jstep = j_make_step(jmesh, jintr, iterations=(10, 5, 4), use_pallas=True, interpret=True)
    mesh = make_mesh(8, devices=["cpu"] * 8)
    step = make_sharded_step(mesh, INTR, iterations=(10, 5, 4), use_pallas=True)
    js = j_init(jintr, resolution=128, size_m=3.0, trunc=0.06, init_pose=jnp.asarray(poses[0]),
                dtype=jnp.int32)
    fields = ("data", "origin", "voxel_size", "trunc", "planes", "pose", "model_maps",
              "model_pose", "frame_index", "last_rmse", "last_corr", "last_tracked")
    for k in range(3):
        vals = (js.volume.data, js.volume.origin, js.volume.voxel_size, js.volume.trunc,
                js.planes, js.pose, js.model_maps, js.model_pose, js.frame_index, js.last_rmse,
                js.last_corr, js.last_tracked)
        carried = {f: np.array(v) for f, v in zip(fields, vals)}
        d = frames[k].numpy()
        j_out = jstep(j_scatter(jmesh, js, use_pallas=True), jnp.asarray(d))
        t_out = single_state_from_sharded(
            step(sharded_state_from_single(mesh, state_from_numpy(carried, device="cpu"), True),
                 frames[k]))
        np.testing.assert_allclose(t_out.pose.numpy(), np.asarray(j_out.pose), atol=1e-4)
        jd, td = np.asarray(j_out.volume.data), t_out.volume.data.numpy()
        np.testing.assert_array_equal(td & 0xFFFF, jd & 0xFFFF)
        obs = (jd & 0xFFFF) > 0
        dq = np.abs((td >> 16).astype(np.int64) - (jd >> 16))[obs]
        assert (dq <= 1).mean() >= 0.999
        jv = np.asarray(j_out.model_maps)[mp.MD_VALID] > 0.5
        tv = t_out.model_maps[mp.MD_VALID].numpy() > 0.5
        assert (jv == tv).mean() >= 0.99
        js = j_step(js, jnp.asarray(d), jintr, use_pallas=True, interpret=True)


def test_xla_path_sharded_matches_reference(mesh):
    """The XLA path of the sharded step against the JAX package's
    ``make_sharded_step(use_pallas=False)`` on its 8-device CPU mesh,
    teacher-forced: before each of 3 frames the reference's sharded state
    is carried into the port's mesh, and both step (the halo exchange, the
    slab-local ray march, the pmin/psum map combine, the coarse ICP levels
    and the finest one summed over row-slabs). Each frame is tracked and
    fused in both (the observed voxels grow). Bounds: poses 1e-4 (the
    pipeline parity's), weights identical, the tsdf within 1e-5 where
    observed (the reference's own bound for its slab-local origins, which
    round the voxel centres differently from the port's global one),
    valid masks on >= 99.5% of pixels (the XLA pipeline parity's),
    vertices and depth 1e-4 m where both are valid, normals < 5e-3 (the
    reference's bound for its sharded maps). The reference's sharded
    state keeps no correspondence count, so none is compared."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    from housescan_tpu.kinfu.camera import Intrinsics as JIntrinsics
    from housescan_tpu.parallel import make_mesh as j_make_mesh
    from housescan_tpu.parallel import make_sharded_step as j_make_step
    from housescan_tpu.parallel.sharded import sharded_kinfu_init as j_init
    from housescan_tpu_torch.kinfu.pipeline import state_from_numpy

    if len(jax.devices()) < 8:
        pytest.skip("the reference's sharded step needs its 8-device CPU mesh")
    half, boxes = furnished_room()
    poses = orbit_poses(4, radius=0.25, yaw_range=0.06, pitch=0.25)
    frames = render_depth_stream(INTR, poses, half, boxes=boxes, device="cpu")
    jintr = JIntrinsics(*INTR)
    jmesh = j_make_mesh(8)
    jstep = j_make_step(jmesh, jintr, max_raycast_steps=48)
    step = make_sharded_step(mesh, INTR, max_raycast_steps=48)
    js = j_init(jmesh, jintr, resolution=64, size_m=3.0, trunc=0.1, init_pose=poses[0])
    n_obs = 0
    for k in range(3):
        pose = np.array(js.pose)
        carried = dict(
            data=np.array(js.volume.data), origin=np.array(js.volume.origin),
            voxel_size=np.array(js.volume.voxel_size), trunc=np.array(js.volume.trunc),
            planes=np.array(js.planes), pose=pose, model_maps=np.array(js.model_maps),
            model_pose=pose, frame_index=np.array(js.frame_index), last_rmse=np.float32(0),
            last_corr=np.int32(0), last_tracked=np.bool_(True))
        ts = sharded_state_from_single(mesh, state_from_numpy(carried, device="cpu"), False)
        js = jstep(js, jnp.asarray(frames[k].numpy()))
        ts = single_state_from_sharded(step(ts, frames[k]))
        np.testing.assert_allclose(ts.pose.numpy(), np.asarray(js.pose), atol=1e-4)
        jd, td = np.asarray(js.volume.data), ts.volume.data.numpy()
        np.testing.assert_array_equal(td[1], jd[1])
        obs = jd[1] > 0
        assert int(obs.sum()) > n_obs, f"frame {k} was not fused"
        n_obs = int(obs.sum())
        np.testing.assert_allclose(td[0][obs], jd[0][obs], atol=1e-5)
        jm, tm = np.asarray(js.model_maps), ts.model_maps.numpy()
        jv, tv = jm[mp.MD_VALID] > 0.5, tm[mp.MD_VALID] > 0.5
        assert jv.sum() > 10000 and (jv == tv).mean() >= 0.995
        both = jv & tv
        np.testing.assert_allclose(tm[mp.MD_V][:, both], jm[mp.MD_V][:, both], atol=1e-4)
        np.testing.assert_allclose(tm[mp.MD_DEPTH][both], jm[mp.MD_DEPTH][both], atol=1e-4)
        assert np.abs(tm[mp.MD_N] - jm[mp.MD_N])[:, both].max() < 5e-3


class TestRooms2D:
    def test_refuse_rooms_2d_matches_single_device(self):
        mesh2d = make_mesh2d(2, 4, devices=["cpu"] * 8)
        half, boxes = furnished_room()
        streams, trajs = [], []
        for ri in range(2):
            poses = orbit_poses(3, radius=0.25, yaw_range=0.1, pitch=0.25 + 0.15 * ri)
            streams.append(render_depth_stream(INTR, poses, half, boxes=boxes, device="cpu"
                                               ).numpy())
            trajs.append(poses)
        vols = refuse_rooms_2d(mesh2d, streams, trajs, INTR, resolution=64, size_m=3.0, trunc=0.1)
        assert len(vols) == 2
        for r in range(2):
            ref = tsdf_new(64, 3.0, 0.1, device="cpu")
            for k in range(3):
                ref = tsdf_integrate(ref, torch.from_numpy(streams[r][k]),
                                     torch.from_numpy(trajs[r][k]), INTR)
            np.testing.assert_array_equal(vols[r].weight.numpy(), ref.weight.numpy())
            np.testing.assert_array_equal(vols[r].tsdf.numpy(), ref.tsdf.numpy())  # exact
        assert not torch.equal(vols[0].tsdf, vols[1].tsdf)


class TestRoomBatchDP:
    @pytest.mark.parametrize("n_rooms", [8, 3])
    def test_sharded_cuboid_fit_exact(self, mesh, n_rooms):
        """8 rooms over 8 shards (the reference's test) and 3 (fewer rooms
        than shards): every fit as the unsplit batch's, error < 1e-3."""
        rng = np.random.default_rng(3)
        batch = []
        for _ in range(n_rooms):
            p = np.concatenate([rng.uniform(-2, 2, 3), rng.uniform(2, 5, 3), rng.normal(size=4)])
            batch.append(cuboid_from_params(torch.tensor(p, dtype=torch.float32)).numpy())
        batch = np.stack(batch)
        fit = fit_cuboids_sharded(batch, mesh)
        assert fit.params.shape == (n_rooms, 10)
        assert float(fit.error.max()) < 1e-3
        whole = fit_cuboid_batch(batch, device="cpu")
        assert torch.equal(fit.params, whole.params) and torch.equal(fit.error, whole.error)
