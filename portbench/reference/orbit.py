"""The orbit cells' comparison with the plain reference.

For a pass of the window the reference replays the same frames, taught
by the program's outputs as a served model's reference is taught by the
served tokens: frame j is tracked by the reference's own ICP from the
program's pose of frame j - 1 against the reference's own model maps,
and then fused at the program's pose of frame j into the reference's own
volume and planes, from which it renders the next model maps. What the
reference takes from the program is the poses and the tracked flags; the
volume, the planes and the maps are its own.

Numbers compared (each the widest gap over what it covers):

  * ``pose_gap_mm``, ``pose_gap_mrad``: the translation and rotation of
    every frame's pose from the reference's, frames 1.. of the pass;
  * ``tsdf_gap``: |tsdf| difference over every voxel either volume has
    observed, at the end of the pass (units of the truncation distance);
  * ``planes_gap``: normal and offset (metres) difference of every
    sub-block plane either side holds valid, at the end of the pass;
  * ``depth_gap_mm``: depth difference of the last model maps over the
    pixels both hold valid;
  * ``valid_gap_px``: pixels valid in one side's last model maps only.
"""

from __future__ import annotations

from typing import Dict, NamedTuple

import torch

from reference import step as ref

NUMBERS = ("pose_gap_mm", "pose_gap_mrad", "tsdf_gap", "planes_gap", "depth_gap_mm",
           "valid_gap_px")


class PassOut(NamedTuple):
    """What a pass produced: (n, 4, 4) poses, (n,) tracked flags, and at
    its end the (2, R, R, R) volume, the planes and the (8, H, W) model
    maps (None where only the poses are compared)."""

    poses: torch.Tensor
    tracked: torch.Tensor
    volume: torch.Tensor = None
    planes: torch.Tensor = None
    maps: torch.Tensor = None


def cam_of(config: dict) -> ref.Cam:
    c = config["camera"]
    return ref.Cam(c["width"], c["height"], c["fx"], c["fy"], c["cx"], c["cy"])


@torch.no_grad()
def replay(frames: torch.Tensor, prog: PassOut, init_pose: torch.Tensor, config: dict,
           want_end: bool = True) -> PassOut:
    """The reference over one pass of ``frames`` ((n, H, W) metres on the
    device), taught by the program's ``prog.poses`` and ``prog.tracked``."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = frames.device
    cam = cam_of(config)
    vcfg, icfg = config["volume"], config["icp"]
    res = int(vcfg["resolution"])
    vs = torch.tensor(vcfg["size_m"] / res, dtype=ref.F32, device=dev)
    origin = torch.full((3,), -vcfg["size_m"] / 2.0, dtype=ref.F32, device=dev)
    trunc = torch.tensor(vcfg["trunc"], dtype=ref.F32, device=dev)
    geom = (res, vs, origin, trunc)
    vol = torch.empty((2, res, res, res), dtype=ref.F32, device=dev)
    vol[0].fill_(1.0)
    vol[1].zero_()
    planes = torch.zeros((res // 8, res // 8, res // 128, 16, 16), dtype=ref.F32, device=dev)
    model = torch.zeros((ref.MODEL_ROWS, cam.height, cam.width), dtype=ref.F32, device=dev)
    pose = init_pose.to(dev, ref.F32)
    model_pose = pose
    tight = torch.clamp(0.5 * vs, min=0.006)
    min_corr = max(32, int(0.002 * cam.width * cam.height))
    levels = int(icfg["levels"])
    out_poses, out_tracked = [], []
    for j in range(frames.shape[0]):
        raw = frames[j]
        if j == 0:
            r_pose, r_tracked = pose, torch.ones((), dtype=torch.bool, device=dev)
        else:
            live = ref.live_pyramid(raw, cam, levels)
            models = [model]
            for _ in range(1, levels):
                models.append(ref.halve(models[-1]))
            icp_pose, _, icp_corr = ref.icp_track(live, models, model_pose, cam,
                                                  tuple(icfg["iterations"]),
                                                  float(icfg["dist_threshold"]),
                                                  float(icfg["angle_threshold"]), tight)
            model_valid = model[ref.MD_VALID] > 0.5
            both = (raw > 0) & model_valid
            incons = torch.where(both, torch.clamp((raw - model[ref.MD_DEPTH]).abs(), max=1.0),
                                 0.0).sum() / torch.clamp(both.sum(), min=1)
            r_tracked = ((icp_corr >= min_corr) & (incons <= 0.15)) | (model_valid.sum() < 4 * min_corr)
            r_pose = torch.where(r_tracked, icp_pose, pose)
        out_poses.append(r_pose)
        out_tracked.append(r_tracked)
        # taught by the program: its pose and its verdict on this frame
        p_pose = prog.poses[j].to(ref.F32)
        p_tracked = bool(prog.tracked[j])
        ref.integrate(vol, planes, raw if p_tracked else torch.zeros_like(raw), p_pose, cam, geom,
                      float(vcfg["max_weight"]))
        maps = ref.raycast(planes, p_pose, cam, geom, float(config["camera"]["z_min"]))
        if p_tracked:
            model, model_pose = maps, p_pose
        pose = p_pose
    return PassOut(torch.stack(out_poses), torch.stack(out_tracked),
                   vol if want_end else None, planes if want_end else None,
                   model if want_end else None)


def _rot_gap(ra: torch.Tensor, rb: torch.Tensor) -> torch.Tensor:
    """Rotation angle (rad) between (n, 3, 3) rotations, by the chord
    ||Ra - Rb||_F = 2 sqrt(2) sin(angle / 2), exact for small angles."""
    chord = (ra.double() - rb.double()).flatten(1).norm(dim=1)
    return 2.0 * torch.asin(torch.clamp(chord / (2.0 * 2.0 ** 0.5), max=1.0))


def numbers(got: PassOut, want: PassOut) -> Dict[str, float]:
    """The widest gaps of ``got`` (the program, or the control) from the
    reference's ``want`` over one pass."""
    out = {}
    gp, wp = got.poses[1:].double(), want.poses[1:].double()
    if gp.shape[0]:
        out["pose_gap_mm"] = float((gp[:, 3, :3] - wp[:, 3, :3]).norm(dim=1).max()) * 1e3
        out["pose_gap_mrad"] = float(_rot_gap(gp[:, :3, :3], wp[:, :3, :3]).max()) * 1e3
    else:
        out["pose_gap_mm"] = out["pose_gap_mrad"] = 0.0
    if got.volume is not None:
        gv, wv = got.volume.float(), want.volume
        seen = (gv[1] > 0) | (wv[1] > 0)
        out["tsdf_gap"] = float(torch.where(seen, (gv[0] - wv[0]).abs(), 0.0).max())
        gvalid = got.planes[:, :, :, 4, :] > 0.5
        wvalid = want.planes[:, :, :, 4, :] > 0.5
        either = gvalid | wvalid
        pg = (got.planes[:, :, :, :4, :] - want.planes[:, :, :, :4, :]).abs().amax(dim=3)
        out["planes_gap"] = float(torch.where(either, pg, 0.0).max())
        gm, wm = got.maps[ref.MD_VALID] > 0.5, want.maps[ref.MD_VALID] > 0.5
        both = gm & wm
        dg = (got.maps[ref.MD_DEPTH] - want.maps[ref.MD_DEPTH]).abs()
        out["depth_gap_mm"] = float(torch.where(both, dg, 0.0).max()) * 1e3
        out["valid_gap_px"] = float((gm ^ wm).sum())
    return out
