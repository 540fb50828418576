"""RANSAC plane detection: the planes.txt producer.

A port of ``housescan_tpu/kinfu/ransac.py``. Each round scores every
hypothesis against the not-yet-claimed points with one (H, 3) x (3, N)
matmul, takes the best, refines it with a weighted total-least-squares
fit of its inliers, claims the refined plane's inliers and repeats;
rounds below ``min_inliers`` accept nothing. The reference's
``jax.lax.scan`` over rounds is a Python loop of ``max_planes`` rounds
on the points' device, and nothing waits for the device until the caller
reads the result.

Randomness comes from a ``torch.Generator`` (seed 0 by default). It
cannot reproduce ``jax.random``'s bits, so the two packages sample
different hypotheses; ``ransac_round`` takes the drawn index arrays, so
a test can hand both the same ones. Hulls and planes.txt are host numpy,
as in the reference: each plane's hull is Andrew's monotone chain over its
projected inliers, compiled (``ops/convex_hull.py``, one host call a
plane) for a cloud on the card, and the Python chain (``convex_hull_2d``)
for a cloud off it; the two give the same bytes.
"""

from __future__ import annotations

from pathlib import Path
from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from housescan_tpu_torch.geometry.fitting import fit_plane_weighted
from housescan_tpu_torch.geometry.plane import PlaneEq
from housescan_tpu_torch.geometry.transform import mm
from housescan_tpu_torch.io import host
from housescan_tpu_torch.io.pcd import save_pcd
from housescan_tpu_torch.io.planes_txt import save_planes_txt
from housescan_tpu_torch.ops import cuda_lib
from housescan_tpu_torch.ops.convex_hull import convex_hull_compiled, sorted_unique
from housescan_tpu_torch.utils.metrics import GLOBAL_METRICS

K_LOCAL = 96  # candidates per local hypothesis


class DetectedPlanes(NamedTuple):
    normals: torch.Tensor  # (P, 3), accepted planes first
    ds: torch.Tensor  # (P,)
    inlier_counts: torch.Tensor  # (P,) int32
    n_planes: torch.Tensor  # () int32 how many entries are real
    inlier_of: torch.Tensor  # (N,) int32 plane index per point, -1 = none


class RansacRound(NamedTuple):
    normals: torch.Tensor  # (H, 3) hypothesis planes
    ds: torch.Tensor  # (H,)
    counts: torch.Tensor  # (H,) inliers among the available points (0 if degenerate)
    best: torch.Tensor  # () chosen hypothesis
    plane: PlaneEq  # refined plane of the best hypothesis's inliers
    final_mask: torch.Tensor  # (N,) available points within the threshold of ``plane``
    accept: torch.Tensor  # () bool
    available: torch.Tensor  # (N,) bool after the round
    inlier_of: torch.Tensor  # (N,) int32 after the round
    plane_idx: torch.Tensor  # () int32 planes accepted so far


def draw_hypothesis_indices(n: int, n_hyp: int, generator: torch.Generator, device,
                            k_local: int = K_LOCAL):
    """Random point indices of one round: (n_hyp - n_hyp // 2, 3) global
    triples, (n_hyp // 2,) local anchors and (n_hyp // 2, k_local) local
    candidates."""
    h_loc = n_hyp // 2
    kw = dict(generator=generator, device=device)
    idx = torch.randint(0, n, (n_hyp - h_loc, 3), **kw)
    anchor = torch.randint(0, n, (h_loc,), **kw)
    cand = torch.randint(0, n, (h_loc, k_local), **kw)
    return idx, anchor, cand


def hypothesis_planes(points: torch.Tensor, idx, anchor, cand):
    """(H, 3) unit normals, (H,) d and (H,) non-degenerate flags.

    The global half of the hypotheses takes random point triples; the
    local half takes an anchor and its two nearest of ``k_local`` random
    candidates, which is what finds small planes (a patch holding a
    fraction f of the cloud is hit by a global triple with probability
    f^3 but by a local one with about f)."""
    h_loc = anchor.shape[0]
    a_l = points[anchor]
    cpts = points[cand]  # (h, K, 3)
    d2 = ((cpts - a_l[:, None]) ** 2).sum(dim=-1)
    d2 = torch.where(d2 < 1e-12, torch.inf, d2)  # drop anchor duplicates
    rows = torch.arange(h_loc, device=points.device)
    i1 = torch.argmin(d2, dim=1)
    d2b = d2.clone()
    d2b[rows, i1] = torch.inf
    i2 = torch.argmin(d2b, dim=1)
    a = torch.cat([points[idx[:, 0]], a_l])
    b = torch.cat([points[idx[:, 1]], cpts[rows, i1]])
    c = torch.cat([points[idx[:, 2]], cpts[rows, i2]])
    normal = torch.linalg.cross(b - a, c - a)
    norm = torch.linalg.norm(normal, dim=1, keepdim=True)
    ok = norm[:, 0] > 1e-9
    normal = normal / torch.clamp(norm, min=1e-12)
    d = (normal * a).sum(dim=1)
    return normal, d, ok


def ransac_round(points, available, inlier_of, plane_idx, idx, anchor, cand,
                 inlier_threshold: float, min_inliers: int) -> RansacRound:
    """One round on given hypothesis indices."""
    normal_h, d_h, ok_h = hypothesis_planes(points, idx, anchor, cand)
    dist = (mm(normal_h, points.T) - d_h[:, None]).abs()  # (H, N) in one product
    inl = (dist < inlier_threshold) & available[None, :]
    counts = torch.where(ok_h, inl.sum(dim=1), 0)
    best = torch.argmax(counts)
    eq = fit_plane_weighted(points, inl[best].to(torch.float32))
    # re-collect the inliers of the refined plane
    final_mask = ((mm(points, eq.normal) - eq.d).abs() < inlier_threshold) & available
    accept = final_mask.sum() >= min_inliers
    return RansacRound(
        normals=normal_h, ds=d_h, counts=counts, best=best, plane=eq, final_mask=final_mask,
        accept=accept,
        available=torch.where(accept, available & ~final_mask, available),
        inlier_of=torch.where(accept & final_mask, plane_idx, inlier_of),
        plane_idx=plane_idx + accept.to(torch.int32),
    )


def detect_planes(
    points: torch.Tensor,
    generator: Optional[torch.Generator] = None,
    max_planes: int = 8,
    n_hypotheses: int = 512,
    inlier_threshold: float = 0.02,
    min_inliers: int = 200,
) -> DetectedPlanes:
    """Detect up to ``max_planes`` planes in an (N, 3) cloud on its
    device. ``generator`` (on that device) defaults to seed 0."""
    points = points.to(torch.float32)
    n = points.shape[0]
    dev = points.device
    i32 = torch.int32
    if n < 3:  # no surface, no planes
        return DetectedPlanes(
            normals=torch.zeros((max_planes, 3), device=dev),
            ds=torch.zeros((max_planes,), device=dev),
            inlier_counts=torch.zeros((max_planes,), dtype=i32, device=dev),
            n_planes=torch.zeros((), dtype=i32, device=dev),
            inlier_of=torch.full((n,), -1, dtype=i32, device=dev),
        )
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    available = torch.ones((n,), dtype=torch.bool, device=dev)
    inlier_of = torch.full((n,), -1, dtype=i32, device=dev)
    plane_idx = torch.zeros((), dtype=i32, device=dev)
    normals, ds, counts, accepts = [], [], [], []
    for _ in range(max_planes):
        idx, anchor, cand = draw_hypothesis_indices(n, n_hypotheses, generator, dev)
        r = ransac_round(points, available, inlier_of, plane_idx, idx, anchor, cand,
                         inlier_threshold, min_inliers)
        available, inlier_of, plane_idx = r.available, r.inlier_of, r.plane_idx
        normals.append(torch.where(r.accept, r.plane.normal, 0.0))
        ds.append(torch.where(r.accept, r.plane.d, 0.0))
        counts.append(torch.where(r.accept, r.final_mask.sum(), 0).to(i32))
        accepts.append(r.accept)
    order = torch.sort((~torch.stack(accepts)).to(i32), stable=True).indices  # accepted first
    return DetectedPlanes(
        normals=torch.stack(normals)[order],
        ds=torch.stack(ds)[order],
        inlier_counts=torch.stack(counts)[order],
        n_planes=plane_idx,
        inlier_of=inlier_of,
    )


def convex_hull_2d(points_2d: np.ndarray) -> np.ndarray:
    """Andrew's monotone chain convex hull (host numpy), as a Python loop."""
    return unique_hull(points_2d)[1]


def unique_hull(points_2d, compiled: bool = False) -> Tuple[np.ndarray, np.ndarray]:
    """The unique float64 rows of ``points_2d`` (``np.unique``, sorted by
    x, then y) and their convex hull: by the Python chain
    (``monotone_chain``, counted in ``plain_counts["convex_hull"]``), or
    with ``compiled`` by the compiled one (``ops/convex_hull.py``, its
    faster dedupe ``sorted_unique``, ``launch_counts["convex_hull"]``),
    which gives the same bytes."""
    if compiled:
        pts = sorted_unique(points_2d)
        cuda_lib.launch_counts["convex_hull"] += 1
        return pts, convex_hull_compiled(pts)
    pts = np.unique(np.asarray(points_2d, np.float64), axis=0)
    cuda_lib.plain_counts["convex_hull"] += 1
    return pts, monotone_chain(pts)


def monotone_chain(pts: np.ndarray) -> np.ndarray:
    """The Python chain over unique float64 rows ``pts``: the strict hull's
    vertices, the lower chain then the upper; two rows or fewer come back
    as they are."""
    if len(pts) <= 2:
        return pts
    pts = pts[np.lexsort((pts[:, 1], pts[:, 0]))]

    def cross2(o, a, b):
        return (a[0] - o[0]) * (b[1] - o[1]) - (a[1] - o[1]) * (b[0] - o[0])

    def half(iterable):
        out: List[np.ndarray] = []
        for p in iterable:
            while len(out) >= 2 and cross2(out[-2], out[-1], p) <= 0:
                out.pop()
            out.append(p)
        return out

    lower = half(pts)
    upper = half(pts[::-1])
    return np.asarray(lower[:-1] + upper[:-1])


def plane_hulls(points, detected: DetectedPlanes) -> List[np.ndarray]:
    """Per-plane 3D boundary polygons (the cloud_plane_hull<k>.pcd
    payloads): project the inliers onto the plane, take the 2D convex
    hull in the plane's basis and lift it back. ``points`` and the
    fields of ``detected`` may be tensors or numpy arrays. For CUDA
    ``points`` each hull is one call of the compiled chain
    (``ops/convex_hull.py``, ``launch_counts["convex_hull"]``); for numpy
    or a CPU tensor the Python chain (``plain_counts["convex_hull"]``).
    Counts ``export.hull_points``, the unique projected points the chains
    took."""
    compiled = isinstance(points, torch.Tensor) and points.is_cuda
    points = host(points)
    normals = host(detected.normals)
    ds = host(detected.ds)
    inlier_of = host(detected.inlier_of)
    hulls = []
    n_unique = 0
    for k in range(int(detected.n_planes)):
        n = normals[k]
        d = ds[k]
        members = points[inlier_of == k]
        if len(members) == 0:
            hulls.append(np.zeros((0, 3), np.float32))
            continue
        helper = np.array([1.0, 0, 0]) if abs(n[0]) < 0.9 else np.array([0, 1.0, 0])
        e1 = np.cross(n, helper)
        e1 /= np.linalg.norm(e1)
        e2 = np.cross(n, e1)
        proj = members - np.outer(members @ n - d, n)  # onto the plane
        uv = np.stack([proj @ e1, proj @ e2], axis=1)
        pts, hull_uv = unique_hull(uv, compiled)
        n_unique += len(pts)
        # exact lift: (e1, e2, n) is orthonormal and every projected
        # point satisfies p . n = d
        hull3d = d * n + hull_uv[:, :1] * e1 + hull_uv[:, 1:2] * e2
        hulls.append(hull3d.astype(np.float32))
    GLOBAL_METRICS.count("export.hull_points", n_unique)
    return hulls


def detect_planes_to_dir(
    points: torch.Tensor,
    out_dir,
    generator: Optional[torch.Generator] = None,
    max_planes: int = 8,
    n_hypotheses: int = 512,
    inlier_threshold: float = 0.02,
    min_inliers: int = 200,
) -> DetectedPlanes:
    """Detect planes and write planes.txt + cloud_plane_hull<k>.pcd into
    a room directory."""
    det = detect_planes(points, generator, max_planes=max_planes, n_hypotheses=n_hypotheses,
                        inlier_threshold=inlier_threshold, min_inliers=min_inliers)
    npl = int(det.n_planes)
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    save_planes_txt(out_dir / "planes.txt", PlaneEq(det.normals[:npl], det.ds[:npl]))
    with GLOBAL_METRICS.span("export.ransac.hulls"):
        hulls = plane_hulls(points, det)
    for k in range(npl):
        save_pcd(out_dir / f"cloud_plane_hull{k}.pcd", hulls[k])
    return det
