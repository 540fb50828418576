"""Projective point-to-plane ICP camera tracking over the map pyramid.

Two paths, as in the reference (``housescan_tpu/kinfu/icp.py``):

  * the kernel path (``use_pallas=True``): each level is one K3 call
    (``ops/icp_cuda.icp_level``), every Gauss-Newton iteration of the
    level with the adaptive tight/wide gate and the null-space-filtered
    6x6 solve;
  * the XLA path (``use_pallas=False``): per iteration, the normal
    equations in torch ops (``_normal_equations``: association along the
    model-map gradients, gates, Huber and incidence weights, the 6x6
    reduction as two full-float32 matmuls), then K2
    (``ops/solve6.solve_twist_compose``) solves and composes the pose.
    The reference's early-exit ``while_loop`` becomes a fixed trip of the
    level's iterations whose updates are masked by a device-side done
    flag (``torch.where``): the same carry, and the host never waits on
    the card. The reference's CPU branch (``jnp.linalg.solve``) is not
    copied: on the CPU K2's plain version runs, which the reference holds
    to that branch at 2e-5.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Sequence

import torch

from housescan_tpu_torch.geometry.transform import mm
from housescan_tpu_torch.kinfu import maps as mp
from housescan_tpu_torch.kinfu.camera import Intrinsics
from housescan_tpu_torch.ops.icp_cuda import BAND_H, _icp_level
from housescan_tpu_torch.ops.solve6 import solve_twist_compose
from housescan_tpu_torch.utils.metrics import GLOBAL_METRICS

# Per level, finest first: association window (0 = +-1.5 px) and Tikhonov
# damping (coarse levels see few pixels of one or two walls).
WINDOWS = (0, 2, 4)
DAMPINGS = (3e-4, 3e-3, 1e-2)
HUBER = 0.02


@functools.lru_cache(maxsize=None)
def _level_names(level: int):
    """A level's span, and its counters' names (iterations run,
    correspondences, visible model pixels)."""
    return (f"track.icp.level{level}",
            tuple(f"icp.level{level}.{c}" for c in ("iterations", "corr", "visible")))


class IcpResult(NamedTuple):
    pose: torch.Tensor  # (4, 4) refined camera-to-world
    rmse: torch.Tensor  # () final point-to-plane RMSE (meters)
    n_corr: torch.Tensor  # () int32 final correspondence count


def _model_gradients(model_vertices: torch.Tensor, model_valid: torch.Tensor):
    """(gu, gv): central-difference (h, w, 3) model-vertex gradients
    along +u and +v, zero where a stencil neighbour is invalid (wrapping
    neighbours, as the reference's roll). Iteration-invariant."""

    def shift(m, dy, dx):
        return torch.roll(m, (-dy, -dx), (0, 1))

    ok_u = shift(model_valid, 0, 1) & shift(model_valid, 0, -1)
    ok_v = shift(model_valid, 1, 0) & shift(model_valid, -1, 0)
    gu = torch.where(ok_u[..., None],
                     0.5 * (shift(model_vertices, 0, 1) - shift(model_vertices, 0, -1)), 0.0)
    gv = torch.where(ok_v[..., None],
                     0.5 * (shift(model_vertices, 1, 0) - shift(model_vertices, -1, 0)), 0.0)
    return gu, gv


def _associate(model_vertices, model_normals, model_valid, grads, u, v, window: int,
               row0: int = 0):
    """Linearised projective association: the model vertex at the
    projected (u, v) is the pixel's own, moved along the gradients by
    (u - px, v - py); kept when both offsets lie within the gate (+-1.5
    px for ``window`` 0, else ``window`` px). ``row0``: the image row of
    the maps' first row (a row-slab of the image)."""
    h, w = u.shape
    gate = 1.5 if window == 0 else float(window)
    py = torch.arange(h, dtype=u.dtype, device=u.device)[:, None] + row0
    px = torch.arange(w, dtype=u.dtype, device=u.device)[None, :]
    du = u - px
    dv = v - py
    near = (du.abs() <= gate) & (dv.abs() <= gate)
    gu, gv = grads
    m_v = model_vertices + gu * du[..., None] + gv * dv[..., None]
    return m_v, model_normals, model_valid & near


def _normal_equations(pose, live_vertices, live_normals, model_vertices, model_normals,
                      model_valid, model_grads, prev_pose, intr: Intrinsics, dist_threshold,
                      angle_threshold: float, window: int = 0, row0: int = 0):
    """One Gauss-Newton iteration's 6x6 normal equations without the
    solve: (a (6, 6), b (6,), n_corr () int32, sq ()), sq the weighted
    squared-residual sum. Live maps are (h, w, 3) in the camera frame,
    model maps (h, w, 3) in the world frame. ``row0`` is the image row of
    the maps' first row when they are a row-slab of the image (the sharded
    step's fine level sums the slabs' systems)."""
    rot = pose[:3, :3]
    t = pose[3, :3]
    v_w = mm(live_vertices, rot) + t
    n_w = mm(live_normals, rot)
    # a real live normal: the discontinuity mask zeroes normals at edges
    live_valid = (live_vertices[..., 2] > 0) & ((live_normals * live_normals).sum(-1) > 0.25)

    # project into the previous camera (projective data association)
    p_rot = prev_pose[:3, :3]
    p_t = prev_pose[3, :3]
    v_pc = mm(v_w - p_t, p_rot.T)
    z = v_pc[..., 2]
    safe_z = torch.where(z > 1e-6, z, 1.0)
    u = intr.fx * v_pc[..., 0] / safe_z + intr.cx
    v = intr.fy * v_pc[..., 1] / safe_z + intr.cy
    inb = (z > 1e-6) & (u >= 0) & (u <= intr.width - 1) & (v >= 0) & (v <= intr.height - 1)

    m_v, m_n, m_ok = _associate(model_vertices, model_normals, model_valid, model_grads, u, v,
                                window, row0=row0)

    diff = v_w - m_v
    dist_ok = (diff * diff).sum(-1) < dist_threshold * dist_threshold
    # sin(angle) between the normals from the cross product (PCL's test)
    cross = torch.linalg.cross(n_w, m_n, dim=-1)
    sin_a = torch.sin(torch.tensor(angle_threshold, dtype=torch.float32))
    angle_ok = (cross * cross).sum(-1) < sin_a * sin_a
    corr = live_valid & inb & m_ok & dist_ok & angle_ok

    # point-to-plane rows g = [v_w x n_m, n_m], residual r = n_m . (m_v - v_w)
    g = torch.cat([torch.linalg.cross(v_w, m_n, dim=-1), m_n], dim=-1)
    r = (m_n * (m_v - v_w)).sum(-1)
    # Huber weight, and cos^2 of the model pixel's viewing angle
    w_rob = torch.clamp(HUBER / torch.clamp(r.abs(), min=1e-9), max=1.0)
    ray = m_v - p_t
    ray = ray / torch.clamp(torch.linalg.norm(ray, dim=-1, keepdim=True), min=1e-9)
    incidence = torch.clamp(-(m_n * ray).sum(-1), min=0.0)
    w = corr.to(v_w.dtype) * w_rob * incidence * incidence
    gw = (g * w[..., None]).reshape(-1, 6)
    rw = (r * w).reshape(-1)

    # the 6x6 reduction: full float32 matmuls (TF32 off, full_fp32_matmul)
    a = torch.matmul(gw.T, gw)
    b = torch.matmul(gw.T, rw)
    n_corr = corr.sum().to(torch.int32)
    sq = ((r * w) ** 2).sum()
    return a, b, n_corr, sq


def _icp_level_iteration(pose, live_vertices, live_normals, model_vertices, model_normals,
                         model_valid, model_grads, prev_pose, intr: Intrinsics, dist_threshold,
                         angle_threshold: float, window: int = 0, damping: float = 3e-4):
    """One XLA-path iteration: (new pose, rmse, n_corr, step norm); the
    solve, twist and compose are K2."""
    a, b, n_corr, sq = _normal_equations(
        pose, live_vertices, live_normals, model_vertices, model_normals, model_valid,
        model_grads, prev_pose, intr, dist_threshold, angle_threshold, window=window,
    )
    new_pose, step_norm = solve_twist_compose(pose, a, b, damping=damping)
    rmse = torch.sqrt(sq / torch.clamp(n_corr, min=1))
    return new_pose, rmse, n_corr, step_norm


def _xla_level(live, model, pose, prev_pose, intr: Intrinsics, iters: int, window: int,
               damping: float, dist, angle_threshold: float, tight_threshold):
    """Every iteration of one level on the XLA path: (pose, rmse, n_corr).

    The reference iterates until a healthy tight iteration's step norm
    falls to 1e-5 or the budget runs out; here all ``iters`` iterations
    run and each update is taken only while the done flag is clear."""
    lv, ln = mp.live_to_hwc(live)
    mv, mn, mok, _ = mp.model_to_hwc(model)
    grads = _model_gradients(mv, mok)
    mok_total = mok.to(torch.float32).sum()
    dev = pose.device
    rmse = torch.zeros((), dtype=torch.float32, device=dev)
    n_corr = torch.zeros((), dtype=torch.int32, device=dev)
    widen_until = torch.zeros((), dtype=torch.int32, device=dev)
    done = torch.zeros((), dtype=torch.bool, device=dev)
    for i in range(iters):
        gate_d = dist if tight_threshold is None else torch.where(i < widen_until, dist, tight_threshold)
        p2, rm, nc, norm = _icp_level_iteration(
            pose, lv, ln, mv, mn, mok, grads, prev_pose, intr, gate_d, angle_threshold,
            window=window, damping=damping,
        )
        was_tight = i >= widen_until
        if tight_threshold is None:
            healthy = torch.ones((), dtype=torch.bool, device=dev)
        else:
            healthy = nc.to(torch.float32) >= 0.1 * mok_total
        widen2 = torch.where(~healthy & was_tight, i + 1 + (iters - i) // 2, widen_until)
        done2 = (norm <= 1e-5) & healthy & was_tight
        live_it = ~done
        pose = torch.where(live_it, p2, pose)
        rmse = torch.where(live_it, rm, rmse)
        n_corr = torch.where(live_it, nc, n_corr)
        widen_until = torch.where(live_it, widen2, widen_until).to(torch.int32)
        done = torch.where(live_it, done2, done)
    return pose, rmse, n_corr


def icp_track(
    live_maps: Sequence[torch.Tensor],
    model_maps: Sequence[torch.Tensor],
    prev_pose: torch.Tensor,
    intr: Intrinsics,
    iterations: Sequence[int] = (10, 5, 4),
    dist_threshold=0.10,
    angle_threshold: float = 0.5236,
    init_pose: Optional[torch.Tensor] = None,
    windows: Sequence[int] = WINDOWS,
    dampings: Sequence[float] = DAMPINGS,
    use_pallas: bool = True,
    *,
    tight_threshold=None,
) -> IcpResult:
    """Track one frame. ``live_maps``/``model_maps`` are per-level
    channel-major (6, h, w) / (8, h, w) maps, level 0 = finest; the pose
    starts at ``init_pose`` (default ``prev_pose``, the model maps'
    render pose). ``iterations``, ``windows``, ``dampings`` and a
    sequence ``dist_threshold`` are indexed by level, finest first (a
    sequence shorter than the pyramid gives every level its last entry);
    levels run coarse to fine. ``tight_threshold`` enables the adaptive
    gate. ``use_pallas`` picks the kernel path (K3) or the XLA path
    (torch ops + K2)."""
    n_levels = len(live_maps)
    pose = prev_pose if init_pose is None else init_pose
    dev = prev_pose.device
    rmse = torch.zeros((), dtype=torch.float32, device=dev)
    n_corr = torch.zeros((), dtype=torch.int32, device=dev)

    def per_level(seq, level):
        return seq[level] if len(seq) == n_levels else seq[-1]

    for level in range(n_levels - 1, -1, -1):
        iters = per_level(iterations, level)
        if iters == 0:
            continue
        if isinstance(dist_threshold, (tuple, list)):
            dist = per_level(dist_threshold, level)
        else:
            dist = dist_threshold
        span, counters = _level_names(level)
        with GLOBAL_METRICS.span(span):
            if use_pallas:
                packed = mp.pack_icp_inputs(
                    live_maps[level],
                    model_maps[level],
                    mp.model_gradients(model_maps[level]),
                    band_h=BAND_H,
                )
                pose, lvl_rmse, lvl_corr = _icp_level(
                    packed,
                    pose,
                    prev_pose,
                    intr.level(level),
                    n_iters=iters,
                    window=per_level(windows, level),
                    dist_threshold=dist,
                    angle_threshold=angle_threshold,
                    damping=per_level(dampings, level),
                    tight_threshold=tight_threshold,
                    counters=counters,
                )
            else:
                pose, lvl_rmse, lvl_corr = _xla_level(
                    live_maps[level], model_maps[level], pose, prev_pose, intr.level(level), iters,
                    per_level(windows, level), per_level(dampings, level), dist, angle_threshold,
                    tight_threshold,
                )
        # report the finest level that had correspondences
        use = lvl_corr > 0
        rmse = torch.where(use, lvl_rmse, rmse)
        n_corr = torch.where(use, lvl_corr, n_corr)
    return IcpResult(pose, rmse, n_corr)
