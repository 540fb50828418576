"""The X-slab sharded fusion step (``housescan_tpu/parallel/sharded.py``).

The TSDF volume is cut into X-slabs over a 1-D mesh (``parallel/mesh.py``),
one slab a shard, each a contiguous tensor of its own on its shard's
device; one controller runs every stage of the step over the shards:

  * integrate, shard-local: no slab writes into another;
  * raycast: each slab renders its own part and the maps combine with
    the collectives (the kernel path: a masked pmin of depth, a pmax of
    the tied block ids, one masked pmax of the vertex, normal and id
    rows, a pmin of the occluder row;
    the XLA path: a ray march through the slab extended by a halo of
    ``halo`` X-planes from each neighbour, then a pmin / psum combine);
  * ICP: the kernel path runs the single-device tracker once (K3; the
    model maps are small and replicated), the XLA path runs its coarse
    levels so (K2) and the finest level as row-slabs of the image whose
    normal equations are psum'd, each solved by K2.

The kernel path (``use_pallas=True``) runs K1 and K3 once and K4, K5 and
K6 once a slab, each slab with the WHOLE volume's origin and its first
global X block (``global_blocks``, ``block_x0``): every float a slab
computes is the one the single-device step computes for its chunks, so
the two are bit-identical wherever the per-slab candidate budget of K6
does not bind (a tie between slabs resolves as K6 resolves one). The
XLA path's integrate does the same (``tsdf_integrate(x_offset=)``), so
its volume is the single-device one's bit for bit; the reference gives
each slab a slab-local origin there, which rounds the voxel centres
differently. Its ray march reads the halo-extended slab with a
slab-local origin, as the reference's.
"""

from __future__ import annotations

from typing import List, NamedTuple, Tuple, Union

import torch

from housescan_tpu_torch.geometry.transform import mm
from housescan_tpu_torch.kinfu import maps as mp
from housescan_tpu_torch.kinfu.camera import Intrinsics
from housescan_tpu_torch.kinfu.icp import _model_gradients, _normal_equations, icp_track
from housescan_tpu_torch.kinfu.pipeline import KinFuState, track_frame
from housescan_tpu_torch.kinfu.preprocess import vertex_normals
from housescan_tpu_torch.kinfu.raycast import raycast
from housescan_tpu_torch.kinfu.tsdf import TsdfVolume, fresh_data, make_volume, tsdf_integrate
from housescan_tpu_torch.ops.raycast_planes import RAW_BID, RAW_OCC, finalize_plane_maps
from housescan_tpu_torch.ops.raycast_tiles import raycast_tiles_maps
from housescan_tpu_torch.ops.solve6 import solve_twist_compose
from housescan_tpu_torch.ops.tsdf_stream import planes_shape, tsdf_integrate_stream
from housescan_tpu_torch.parallel.mesh import Mesh, pmax, pmin, ppermute, psum

DUMMY_PLANES = (1, 1, 1, 16, 16)


class ShardedVolume(NamedTuple):
    """A volume as X-slabs: ``slabs[i]`` is shard i's part of ``data``,
    packed (X/n, Y, Z) int32 or (2, X/n, Y, Z) float32 / bfloat16, on its
    shard's device; the geometry is the whole volume's, on the first
    shard's device."""

    slabs: List[torch.Tensor]
    origin: torch.Tensor
    voxel_size: torch.Tensor
    trunc: torch.Tensor

    @property
    def packed_i32(self) -> bool:
        return self.slabs[0].dim() == 3

    @property
    def x_axis(self) -> int:
        return 0 if self.packed_i32 else 1

    @property
    def dims(self) -> Tuple[int, int, int]:
        s = self.slabs[0].shape[self.x_axis:]
        return (s[0] * len(self.slabs), s[1], s[2])

    def slab(self, i: int) -> TsdfVolume:
        """Shard i's slab as a volume with the WHOLE volume's geometry (the
        kernel path's view), on its device."""
        dev = self.slabs[i].device
        return TsdfVolume(self.slabs[i], self.origin.to(dev), self.voxel_size.to(dev),
                          self.trunc.to(dev))

    def gather(self, device=None) -> TsdfVolume:
        """The whole volume on ``device`` (default the first shard's)."""
        dev = torch.device(device) if device is not None else self.origin.device
        data = torch.cat([s.to(dev) for s in self.slabs], dim=self.x_axis)
        return TsdfVolume(data, self.origin.to(dev), self.voxel_size.to(dev), self.trunc.to(dev))


class ShardedKinFuState(NamedTuple):
    volume: ShardedVolume
    # the kernel path: each slab's persistent planes, X-block sliced like
    # the volume; the XLA path: one (1, 1, 1, 16, 16) dummy
    planes: Union[List[torch.Tensor], torch.Tensor]
    pose: torch.Tensor  # (4, 4), on the first shard's device
    model_maps: torch.Tensor  # (8, H, W), replicated (one copy)
    frame_index: torch.Tensor


def _split(data: torch.Tensor, mesh: Mesh) -> List[torch.Tensor]:
    """``data`` cut into the mesh's X-slabs, each a contiguous tensor of
    its own on its shard's device (a float slab must not be an X-range
    view of the (2, X, Y, Z) array: the kernels take X Y Z cells between
    its two planes)."""
    axis = 0 if data.dim() == 3 else 1
    nx = data.shape[axis]
    if nx % mesh.size:
        raise ValueError(f"{nx} X-planes do not split over {mesh.size} shards")
    return [c.to(d, memory_format=torch.contiguous_format, copy=True)
            for c, d in zip(torch.chunk(data, mesh.size, dim=axis), mesh.devices)]


def _check_tiling(resolution: int, n: int) -> None:
    if resolution % 128 or (resolution // 8) % n:
        raise ValueError(f"the sharded kernel path needs a volume tiling into (8, 8, 128) chunks "
                         f"whose X blocks split over {n} shards, got {resolution}")


def sharded_kinfu_init(
    mesh: Mesh,
    intr: Intrinsics,
    resolution: int = 128,
    size_m: float = 3.0,
    trunc: float = 0.06,
    init_pose=None,
    use_pallas: bool = False,
    *,
    dtype=None,
) -> ShardedKinFuState:
    """A fresh state, the volume allocated slab by slab on the mesh. The
    layout is the reference's (packed for ``use_pallas``, float32 else)
    unless ``dtype`` names one (int32, float32, bfloat16)."""
    n = mesh.size
    dtype = dtype or (torch.int32 if use_pallas else torch.float32)
    if use_pallas:
        _check_tiling(resolution, n)
    elif resolution % n:
        raise ValueError(f"{resolution} X-planes do not split over {n} shards")
    shape = (resolution // n, resolution, resolution)
    dev0 = mesh.devices[0]
    vol = ShardedVolume(
        slabs=[fresh_data(shape, dtype, d) for d in mesh.devices],
        origin=torch.full((3,), -size_m / 2.0, dtype=torch.float32, device=dev0),
        voxel_size=torch.tensor(size_m / resolution, dtype=torch.float32, device=dev0),
        trunc=torch.tensor(trunc, dtype=torch.float32, device=dev0),
    )
    if use_pallas:
        planes = [torch.zeros(planes_shape(shape), dtype=torch.float32, device=d)
                  for d in mesh.devices]
    else:
        planes = torch.zeros(DUMMY_PLANES, dtype=torch.float32, device=dev0)
    pose = (torch.eye(4, dtype=torch.float32, device=dev0) if init_pose is None
            else torch.as_tensor(init_pose, dtype=torch.float32).to(dev0).clone())
    return ShardedKinFuState(
        volume=vol,
        planes=planes,
        pose=pose,
        model_maps=torch.zeros((mp.MODEL_ROWS, intr.height, intr.width), dtype=torch.float32,
                               device=dev0),
        frame_index=torch.zeros((), dtype=torch.int32, device=dev0),
    )


def _local_volume(vol: ShardedVolume, i: int, grids, x_off: int = 0) -> TsdfVolume:
    """The (tsdf, weight) ``grids`` of shard i as a self-contained volume
    with the slab-local origin less ``x_off`` voxels along x (the XLA
    path's ray-march view, the reference's rounding)."""
    dev = vol.slabs[i].device
    nx_local = vol.dims[0] // len(vol.slabs)
    vs = vol.voxel_size.to(dev)
    shift = torch.tensor([1.0, 0.0, 0.0], dtype=torch.float32, device=dev)
    origin = vol.origin.to(dev) + shift * (float(i) * nx_local * vs)
    if x_off:
        origin = origin - torch.tensor([float(x_off), 0.0, 0.0], device=dev) * vs
    return make_volume(grids[0], grids[1], origin, vs, vol.trunc.to(dev))


def _halo_extend_x(tsdfs: List[torch.Tensor], weights: List[torch.Tensor], halo: int):
    """Each slab's (tsdf, weight) with ``halo`` X-planes of each
    neighbour before and after it (ppermute both ways around the ring);
    the first and last slabs' outer halos, which wrapped around, are
    unobserved (weight 0, tsdf +1)."""
    n = len(tsdfs)
    fwd = [(i, (i + 1) % n) for i in range(n)]
    bwd = [(i, (i - 1) % n) for i in range(n)]

    def exchange(arrs):
        from_left = ppermute([a[-halo:] for a in arrs], fwd)
        from_right = ppermute([a[:halo] for a in arrs], bwd)
        return [torch.cat([l, a, r]) for l, a, r in zip(from_left, arrs, from_right)]

    ext_t, ext_w = exchange(tsdfs), exchange(weights)
    ext_t[0][:halo] = 1.0
    ext_w[0][:halo] = 0.0
    ext_t[-1][-halo:] = 1.0
    ext_w[-1][-halo:] = 0.0
    return ext_t, ext_w


def _combine_plane_maps(raws: List[torch.Tensor], device) -> torch.Tensor:
    """The slabs' raw (9, H, W) plane maps combined as the whole volume's
    would be: the nearest hit wins, and a tie between slabs goes to the
    larger block id, as K6 breaks a tie inside a tile (a masked pmin of
    depth, a pmax of the tied block ids, then one masked pmax of the
    vertex, normal and id rows over the slab holding that block; the
    vertices of tied slabs are equal, computed from the same depth); the
    occluder event is the nearest of any slab's. The reference's combine
    takes each row's maximum over every tied slab, which mixes the
    normals of different blocks where two slabs tie."""
    big = 1.0e9
    on = [device]
    mys = [torch.where(r[mp.MD_DEPTH] > 0, r[mp.MD_DEPTH], float("inf")) for r in raws]
    best_all = pmin(mys)
    wins = [(r[mp.MD_DEPTH] > 0) & (m <= b) for r, m, b in zip(raws, mys, best_all)]
    bids = [torch.where(w, r[RAW_BID], -1.0) for r, w in zip(raws, wins)]
    best_bid = pmax(bids)
    sels = [w & (b == bb) for w, b, bb in zip(wins, bids, best_bid)]
    best = best_all[0].to(device)
    any_win = best_bid[0].to(device) >= 0
    rows = pmax([torch.where(s[None], r[1:RAW_OCC], -big) for r, s in zip(raws, sels)], on)[0]
    rows = torch.where(any_win[None], rows, 0.0)
    bid = torch.where(any_win, rows[RAW_BID - 1], -1.0)
    depth = torch.where(any_win, torch.where(torch.isinf(best), 0.0, best), 0.0)
    occ = pmin([r[RAW_OCC] for r in raws], on)[0]
    return torch.cat([depth[None], rows[: RAW_BID - 1], bid[None], occ[None]], dim=0)


def make_sharded_step(
    mesh: Mesh,
    intr: Intrinsics,
    levels: int = 3,
    iterations: Tuple[int, ...] = (4, 3, 3),
    max_raycast_steps: int = 96,
    halo: int = 2,
    use_pallas: bool = False,
    *,
    z_min: float = 0.3,
    max_weight: float = 128.0,
):
    """The sharded fusion step for ``mesh``: step(state, raw_depth,
    forced_pose=None) -> state. Tracks (the kernel path: K3 once; the XLA
    path: coarse levels once, the finest level psum'd over row-slabs),
    gates the frame as ``kinfu_step`` does, integrates every slab in
    place and renders the next model maps. ``forced_pose`` fuses at a
    known pose without tracking. The step never waits on the card."""
    n = mesh.size
    dev0 = mesh.devices[0]

    @torch.no_grad()
    def fuse(state: ShardedKinFuState, raw_depth, new_pose, tracked) -> ShardedKinFuState:
        depth = torch.where(tracked, raw_depth, 0.0)
        vol = state.volume
        if use_pallas:
            nbx_local = vol.dims[0] // 8 // n
            raws = []
            for i, dev in enumerate(mesh.devices):
                sv = vol.slab(i)
                d_i, p_i = depth.to(dev), new_pose.to(dev)
                tsdf_integrate_stream(sv, state.planes[i], d_i, p_i, intr, max_weight=max_weight,
                                      global_blocks=(nbx_local * n, nbx_local * i))
                raws.append(raycast_tiles_maps(state.planes[i], p_i, intr, sv, z_min=z_min,
                                               block_x0=nbx_local * i))
            model_maps = finalize_plane_maps(_combine_plane_maps(raws, dev0),
                                             voxel_size=vol.voxel_size)
        else:
            nx_local = vol.dims[0] // n
            tsdfs, weights = [], []
            for i, dev in enumerate(mesh.devices):
                sv = vol.slab(i)
                tsdf_integrate(sv, depth.to(dev), new_pose.to(dev), intr, max_weight=max_weight,
                               x_offset=i * nx_local)
                tsdfs.append(sv.tsdf)
                weights.append(sv.weight)
            ext_t, ext_w = _halo_extend_x(tsdfs, weights, halo)
            rcs = [raycast(_local_volume(vol, i, (ext_t[i], ext_w[i]), x_off=halo),
                           new_pose.to(dev), intr, z_min=z_min, max_steps=max_raycast_steps)
                   for i, dev in enumerate(mesh.devices)]
            on = [dev0]
            mys = [torch.where(rc.valid, rc.depth, float("inf")) for rc in rcs]
            best_all = pmin(mys)
            wins = [rc.valid & (m <= b) for rc, m, b in zip(rcs, mys, best_all)]
            verts = psum([torch.where(w[..., None], rc.vertices, 0.0) for rc, w in zip(rcs, wins)],
                         on)[0]
            n_win = psum([w.to(torch.float32) for w in wins], on)[0]
            # ties across the halo overlap: the mean of equal values
            verts = verts / torch.clamp(n_win[..., None], min=1.0)
            valid = n_win > 0
            best = best_all[0].to(dev0)
            depth_out = torch.where(valid, torch.where(torch.isinf(best), 0.0, best), 0.0)
            rot = new_pose[:3, :3]
            v_cam = torch.where(valid[..., None], mm(verts - new_pose[3, :3], rot.T), 0.0)
            n_cam = vertex_normals(v_cam)
            normals = mm(n_cam, rot)
            valid = valid & ((n_cam * n_cam).sum(-1) > 0.25)
            model_maps = mp.model_from_hwc(torch.where(valid[..., None], verts, 0.0),
                                           torch.where(valid[..., None], normals, 0.0),
                                           valid, depth_out)
        return ShardedKinFuState(
            volume=vol,
            planes=state.planes,
            pose=new_pose,
            model_maps=torch.where(tracked, model_maps, state.model_maps),
            frame_index=state.frame_index + 1,
        )

    @torch.no_grad()
    def step(state: ShardedKinFuState, raw_depth, forced_pose=None) -> ShardedKinFuState:
        raw_depth = torch.as_tensor(raw_depth).to(device=dev0, dtype=torch.float32)

        def icp(live, model_pyr, start, tight):
            gates = (tight, 0.05, 0.10)
            if use_pallas:
                out = icp_track(live, model_pyr, start, intr, iterations=iterations,
                                dist_threshold=gates, tight_threshold=tight, use_pallas=True)
                return out.pose, out.rmse, out.n_corr
            coarse = icp_track(live, model_pyr, start, intr,
                               iterations=(0,) + tuple(iterations[1:]), dist_threshold=gates,
                               tight_threshold=tight, use_pallas=False)
            pose, n_corr = _fine_level(mesh, live[0], model_pyr[0], coarse.pose, start, intr,
                                       tight, iterations[0], coarse.n_corr)
            return pose, coarse.rmse, n_corr

        tr = track_frame(raw_depth, intr, state, state.pose, state.volume.voxel_size, icp,
                         levels, forced_pose)
        return fuse(state, raw_depth, tr.pose, tr.tracked)

    return step


def _fine_level(mesh: Mesh, live, model, pose, prev_pose, intr: Intrinsics, gate, iters: int,
                n_corr):
    """The XLA path's finest ICP level: every Gauss-Newton iteration sums
    the normal equations of the image's row-slabs (one a shard, with its
    first row) and solves them with K2. The gate is the tight one (the
    finest level's loose gate equals it). The correspondence count keeps
    the coarse levels' where this level finds none, as ``icp_track``
    reports the finest level that had any."""
    lv, ln = mp.live_to_hwc(live)
    mv, mn, mok, _ = mp.model_to_hwc(model)
    gu, gv = _model_gradients(mv, mok)
    h = lv.shape[0]
    if h % mesh.size:
        raise ValueError(f"{h} image rows do not split over {mesh.size} shards")
    rows = h // mesh.size
    dev0 = pose.device
    slabs = []
    for i, dev in enumerate(mesh.devices):
        r = slice(i * rows, (i + 1) * rows)
        slabs.append(tuple(a[r].to(dev) for a in (lv, ln, mv, mn, mok, gu, gv)))
    for _ in range(iters):
        parts = [
            _normal_equations(pose.to(dev), s[0], s[1], s[2], s[3], s[4], (s[5], s[6]),
                              prev_pose.to(dev), intr, gate.to(dev), 0.5236, window=0,
                              row0=i * rows)
            for i, (dev, s) in enumerate(zip(mesh.devices, slabs))
        ]
        a, b, nc = (psum([p[k] for p in parts], [dev0])[0] for k in range(3))
        pose, _ = solve_twist_compose(pose, a, b)
        n_corr = torch.where(nc > 0, nc, n_corr)
    return pose, n_corr


def single_state_from_sharded(state: ShardedKinFuState, *, device=None) -> KinFuState:
    """The sharded state gathered into a single-device ``KinFuState`` on
    ``device`` (default the first shard's): the scan-checkpoint schema,
    so a sharded room resumes mid-scan like a single-device one. The
    sharded state has one pose for both of the state's poses and no
    tracking diagnostics: rmse 0, 0 correspondences, tracked."""
    vol = state.volume.gather(device)
    dev = vol.data.device
    planes = (torch.cat([p.to(dev) for p in state.planes]) if isinstance(state.planes, list)
              else state.planes.to(dev))
    pose = state.pose.to(dev)
    return KinFuState(
        volume=vol,
        planes=planes,
        pose=pose,
        model_maps=state.model_maps.to(dev),
        model_pose=pose.clone(),
        frame_index=state.frame_index.to(dev),
        last_rmse=torch.zeros((), dtype=torch.float32, device=dev),
        last_corr=torch.zeros((), dtype=torch.int32, device=dev),
        last_tracked=torch.ones((), dtype=torch.bool, device=dev),
    )


def sharded_state_from_single(mesh: Mesh, kstate: KinFuState, use_pallas: bool) -> ShardedKinFuState:
    """A single-device state (a loaded scan checkpoint, or the
    single-device step's state to compare with) cut into the mesh's
    X-slabs: copies, the single state is left as it is."""
    vol = kstate.volume
    dev0 = mesh.devices[0]
    if use_pallas:
        _check_tiling(vol.dims[0], mesh.size)
        nbx_local = kstate.planes.shape[0] // mesh.size
        planes = [kstate.planes[i * nbx_local:(i + 1) * nbx_local].to(d, copy=True)
                  for i, d in enumerate(mesh.devices)]
    else:
        planes = torch.zeros(DUMMY_PLANES, dtype=torch.float32, device=dev0)
    return ShardedKinFuState(
        volume=ShardedVolume(_split(vol.data, mesh), vol.origin.to(dev0).clone(),
                             vol.voxel_size.to(dev0).clone(), vol.trunc.to(dev0).clone()),
        planes=planes,
        pose=kstate.pose.to(dev0).clone(),
        model_maps=kstate.model_maps.to(dev0).clone(),
        frame_index=kstate.frame_index.to(dev0).clone(),
    )


def sharded_fusion_step(state, raw_depth, mesh: Mesh, intr: Intrinsics, *, forced_pose=None,
                        **kwargs):
    """One step through a step built for the call (a loop builds it once
    with ``make_sharded_step``)."""
    return make_sharded_step(mesh, intr, **kwargs)(state, raw_depth, forced_pose=forced_pose)
