"""Isosurface extraction: TSDF volume -> triangle mesh, on the volume's device.

Marching tetrahedra as in ``housescan_tpu/kinfu/marching_cubes.py``: each
cell splits into 6 tetrahedra around its 0-6 diagonal, and each tet's 16
sign cases triangulate with at most 2 triangles from a case table that is
generated, not transcribed. Triangles are oriented so that their normals
point from the inside (tsdf < 0) to free space, and a cell emits only
when all 8 corner weights pass ``min_weight``. The output is the same
triangle soup in the same order: X-slab by X-slab (the last slab clamped
to the volume, its overlap cells owned by the slab before), then by
triangle slot (tet * 2 + slot), then cell raster order.

The reference builds dense per-cell slot arrays for a whole slab and
compacts them into a speculative fixed-size buffer, a TPU shape device.
For a CUDA volume ``marching_cubes`` launches K10
(``ops/marching_tets.launch_marching_tets``, ``csrc/marching_tets.cu``):
the same soup, bit for bit, from one call of three kernels. For a CPU
volume it runs ``marching_cubes_plain``: each slab first lists its active
cells (observed, corner signs mixed; a cell whose corners all share a
sign emits nothing) with ``torch.nonzero``, evaluates the tets on those
cells only in float32 (a bfloat16 volume widened, as the reference
widens it), and keeps the valid slots; only the real triangles go to the
host. The reference computes this in XLA, outside any Pallas kernel.
"""

from __future__ import annotations

import numpy as np
import torch

from housescan_tpu_torch.io.ply import Mesh
from housescan_tpu_torch.kinfu.tsdf import TsdfVolume
from housescan_tpu_torch.ops import cuda_lib
from housescan_tpu_torch.ops.marching_tets import capped, launch_marching_tets, soup_mesh

# Cube corners in standard MC ordering (bit k of a case = corner k inside).
_CORNERS = np.array(
    [[0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0], [0, 0, 1], [1, 0, 1], [1, 1, 1], [0, 1, 1]],
    np.int32,
)
# Six tetrahedra around the 0-6 main diagonal; each entry indexes _CORNERS.
_TETS = np.array(
    [[0, 1, 2, 6], [0, 2, 3, 6], [0, 3, 7, 6], [0, 7, 4, 6], [0, 4, 5, 6], [0, 5, 1, 6]],
    np.int32,
)
# Tet-local edges as (corner a, corner b) local indices.
_TET_EDGES = np.array([[0, 1], [0, 2], [0, 3], [1, 2], [1, 3], [2, 3]], np.int32)


def _build_tet_cases():
    """(16, 2, 3) triangle table: per sign case, up to 2 triangles whose
    vertices are tet-edge ids; -1 pads."""
    edge_id = {}
    for e, (a, b) in enumerate(_TET_EDGES):
        edge_id[(int(a), int(b))] = e
        edge_id[(int(b), int(a))] = e
    table = -np.ones((16, 2, 3), np.int32)
    for case in range(16):
        inside = [c for c in range(4) if case & (1 << c)]
        outside = [c for c in range(4) if not case & (1 << c)]
        if len(inside) == 1:
            a = inside[0]
            tris = [[edge_id[(a, o)] for o in outside]]
        elif len(inside) == 3:
            o = outside[0]
            tris = [[edge_id[(o, i)] for i in inside]]
        elif len(inside) == 2:
            a, b = inside
            c, d = outside
            q = [edge_id[(a, c)], edge_id[(b, c)], edge_id[(b, d)], edge_id[(a, d)]]
            tris = [[q[0], q[1], q[2]], [q[0], q[2], q[3]]]
        else:
            tris = []
        for t, tri in enumerate(tris):
            table[case, t] = tri
    return table


_TET_CASES = _build_tet_cases()


def _cell_triangles(corner_t, base, origin, voxel_size):
    """Triangles of M active cells: (12, M, 9) world vertices (v0, v1, v2
    xyz, oriented) and (12, M) validity, slot = tet * 2 + slot."""
    dev = corner_t[0].device
    cases = torch.from_numpy(_TET_CASES).to(dev)
    verts, valid = [], []
    for tet in _TETS:
        vals = [corner_t[int(c)] for c in tet]
        edge_pts = []  # 6 x (M, 3)
        for a, b in _TET_EDGES:
            va, vb = vals[int(a)], vals[int(b)]
            ca, cb = _CORNERS[tet[int(a)]], _CORNERS[tet[int(b)]]
            denom = vb - va
            big = denom.abs() > 1e-12
            safe = torch.where(big, denom, 1.0)
            frac = torch.clamp(torch.where(big, -va / safe, 0.5), 0.0, 1.0)
            edge_pts.append(torch.stack(
                [base[k] + int(ca[k]) + frac * int(cb[k] - ca[k]) for k in range(3)], -1))
        edge_pts = torch.stack(edge_pts)  # (6, M, 3)
        neg = [(v < 0) for v in vals]
        bits = (neg[0].to(torch.int64) | (neg[1].to(torch.int64) << 1)
                | (neg[2].to(torch.int64) << 2) | (neg[3].to(torch.int64) << 3))
        # reference point inside the negative region, for orientation
        neg_f = [m.to(torch.float32) for m in neg]
        neg_n = neg_f[0] + neg_f[1] + neg_f[2] + neg_f[3]
        ref = []
        for k in range(3):
            r = torch.zeros_like(neg_n)
            for local in range(4):
                r = r + (base[k] + int(_CORNERS[tet[local]][k])) * neg_f[local]
            ref.append(r / torch.clamp(neg_n, min=1.0))
        cells = torch.arange(bits.shape[0], device=dev)
        for slot in range(2):
            tri = cases[bits, slot]  # (M, 3) edge ids, -1 = none
            valid.append(tri[:, 0] >= 0)
            v0, v1, v2 = (edge_pts[torch.clamp(tri[:, v], min=0), cells] for v in range(3))
            e1 = v1 - v0
            e2 = v2 - v0
            n = [
                e1[:, 1] * e2[:, 2] - e1[:, 2] * e2[:, 1],
                e1[:, 2] * e2[:, 0] - e1[:, 0] * e2[:, 2],
                e1[:, 0] * e2[:, 1] - e1[:, 1] * e2[:, 0],
            ]
            dot = sum(n[k] * ((v0[:, k] + v1[:, k] + v2[:, k]) / 3.0 - ref[k]) for k in range(3))
            flip = (dot < 0)[:, None]
            out = torch.cat([v0, torch.where(flip, v2, v1), torch.where(flip, v1, v2)], -1)
            verts.append((out + 0.5) * voxel_size + origin.repeat(3))
    return torch.stack(verts), torch.stack(valid)


def marching_cubes(vol: TsdfVolume, slab: int = 16, min_weight: float = 1.0,
                   max_triangles: int = 0) -> Mesh:
    """Zero-isosurface triangle soup of a TSDF volume in any layout (host
    Mesh: (3T, 3) float32 vertices, faces 0..3T-1), by X-slabs of
    ``slab`` cells. A nonzero ``max_triangles`` caps the mesh: a larger
    one keeps its first ``max_triangles`` triangles and says so on
    stderr. K10 for a CUDA volume, the plain version for a CPU one."""
    if vol.data.is_cuda:
        return launch_marching_tets(vol, slab, min_weight, max_triangles)
    cuda_lib.plain_counts["marching_tets"] += 1
    return marching_cubes_plain(vol, slab, min_weight, max_triangles)


def marching_cubes_plain(vol: TsdfVolume, slab: int = 16, min_weight: float = 1.0,
                         max_triangles: int = 0) -> Mesh:
    """``marching_cubes`` as tensor code on the volume's device."""
    nx, ny, nz = vol.dims
    slab = min(slab, nx - 1)
    empty = soup_mesh(np.zeros((0, 9), np.float32))
    if slab <= 0:
        return empty
    origin = vol.origin.to(torch.float32)
    t_all, w_all = vol.tsdf, vol.weight  # views, or unpacked once
    out = []
    for i in range(-(-(nx - 1) // slab)):
        x0 = min(i * slab, nx - 1 - slab)  # the last slab is clamped ...
        ts = t_all[x0 : x0 + slab + 1].float()  # bfloat16 widened; float32 as is
        ws = w_all[x0 : x0 + slab + 1].float()
        ok = (ws >= min_weight) & (ws > 0)
        observed = any_neg = all_neg = None
        for dx, dy, dz in _CORNERS:
            sl = (slice(dx, dx + slab), slice(dy, dy + ny - 1), slice(dz, dz + nz - 1))
            c_neg = ts[sl] < 0
            observed = ok[sl] if observed is None else observed & ok[sl]
            any_neg = c_neg if any_neg is None else any_neg | c_neg
            all_neg = c_neg if all_neg is None else all_neg & c_neg
        active = observed & any_neg & ~all_neg
        active[: i * slab - x0] = False  # ... and owns only cells x >= i * slab
        cx, cy, cz = torch.nonzero(active).unbind(1)
        if cx.numel() == 0:
            continue
        corner_t = [ts[cx + int(dx), cy + int(dy), cz + int(dz)] for dx, dy, dz in _CORNERS]
        base = [(cx + x0).to(torch.float32), cy.to(torch.float32), cz.to(torch.float32)]
        verts, valid = _cell_triangles(corner_t, base, origin, vol.voxel_size)
        out.append(verts[valid])  # slot-major, then cell raster order
    if not out:
        return empty
    tris = torch.cat(out)  # (T, 9): only the real triangles
    tris = tris[: capped(len(tris), max_triangles)]
    return soup_mesh(tris.cpu().numpy())
