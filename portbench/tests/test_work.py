"""The roofline counts on a hand-built frame, against counts made by hand."""

import math

import numpy as np
import pytest
import torch

from harness.peaks import bound
from metrics.work import icp_level, tsdf_stream

CAM = dict(width=16, height=8, fx=16.0, fy=16.0, cx=7.5, cy=3.5)


def test_k3_reads_each_level_once_and_counts_valid_pixels():
    depth = torch.zeros(8, 16)
    depth[:, :12] = 2.0  # 96 pixels with depth
    n_bytes, n_ops = icp_level.frame_work(depth, levels=3)
    assert n_bytes == 19 * 4 * (8 * 16 + 4 * 8 + 2 * 4)
    valid = 96 + (4 * 6) + (2 * 3)  # point samples (2^l i, 2^l j) with depth
    assert n_ops == icp_level.OPS_PER_PIXEL * valid


def _brute_chunks(depth, pose, cam, res, size, trunc):
    """Each ray walked in 1/8-voxel steps, in float64, one ray at a time."""
    vox = size / res
    seen = set()
    h, w = depth.shape
    for v in range(h):
        for u in range(w):
            d = float(depth[v, u])
            if d <= 0:
                continue
            ray = np.array([(u - cam["cx"]) / cam["fx"], (v - cam["cy"]) / cam["fy"], 1.0])
            unit = ray / np.linalg.norm(ray)
            rng = d * np.linalg.norm(ray)
            for s in np.arange(-trunc, trunc + 1e-12, vox / 8):
                p = unit * (rng + s) @ pose[:3, :3] + pose[3, :3]
                i = np.floor((p + size / 2) / vox).astype(int)
                if ((i >= 0) & (i < res)).all():
                    seen.add((i[0] // 8, i[1] // 8, i[2] // 128))
    return len(seen)


@pytest.mark.parametrize("yaw", [0.0, 0.3])
def test_k4_band_chunks_of_a_wall(yaw):
    """A flat wall 1 m ahead of a camera at the origin: the chunks its
    band reaches, counted by the benchmark and by a slow walk."""
    res, size, trunc = 128, 3.0, 0.03
    depth = torch.full((8, 16), 1.0)
    depth[0, 0] = 0.0  # a missing sample counts nothing
    c, s = math.cos(yaw), math.sin(yaw)
    pose = np.eye(4, dtype=np.float32)
    pose[:3, :3] = np.array([[c, 0, -s], [0, 1, 0], [s, 0, c]], np.float32)
    got = tsdf_stream.band_chunks(depth, pose, CAM, res, size, trunc)
    want = _brute_chunks(depth.numpy(), pose.astype(np.float64), CAM, res, size, trunc)
    assert got == want
    n_bytes, n_ops = tsdf_stream.frame_work(depth, pose, CAM, res, size, trunc)
    assert n_bytes == got * (2 * 8192 * 8 + 1024) + 16 * 8 * 4
    assert n_ops == got * 8192 * tsdf_stream.OPS_PER_VOXEL


def test_bound_names_what_binds():
    b = bound(3.35e9, 1.0)
    assert b.by == "bytes" and b.seconds == pytest.approx(1e-3)
    b = bound(1.0, 67e9)
    assert b.by == "ops" and b.seconds == pytest.approx(1e-3)
