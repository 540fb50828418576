"""The scan cells' comparison with the plain reference.

A scan is the port's ``scan_to_room_dir``: a recorded stream fused frame
by frame, then the room directory written from the volume (the export).
The reference checks both halves with plain PyTorch and numpy that import
nothing of the program:

  * the fusion by ``reference/orbit.replay``, taught by the program's
    poses and tracked flags (``trajectory.npz``) as in the orbit cells:
    the reference's own ICP gives the poses compared, and its own
    integrate at the program's poses gives the volume that it exports;
  * the export of that volume, as the port computes it: the zero-crossing
    surface points in raster order with their sub-voxel offset
    (``cloud_bin.pcd``), the downsample drawn by
    ``numpy.random.default_rng(0)``, RANSAC with the same
    ``torch.Generator`` draws (seed 0, the points' device, the same calls
    in the same order), each plane's hull (``planes.txt``,
    ``cloud_plane_hull<k>.pcd``) and the marching-tetrahedra mesh in the
    port's triangle order (``mesh.ply``).

The export computes the same float32 (hulls: float64) operations in the
same order as the port, so a sound program reads 0 on every export
number. Departures from the program's arithmetic: the surface points are
computed by X-blocks of ``SURFACE_BLOCK`` planes (the same points in the
same order; the whole-volume masks of the port would not leave room for
a second volume at 1024^3), and the files are read back by this module's
own readers of binary .pcd and .ply.

Numbers compared (each the widest gap over what it covers):

  * ``pose_gap_mm``, ``pose_gap_mrad``: every pose of the trajectory
    from the reference's, frames 1..;
  * ``cloud_gap_mm``: distance between the i-th points of the two
    ``cloud_bin.pcd`` clouds, over the points both have;
    ``cloud_count_gap``: the difference of their counts;
  * ``plane_gap``: normal and offset (metres) of each plane of
    ``planes.txt`` from the reference's plane of the same rank;
  * ``hull_gap_mm``: the Hausdorff distance between each plane's hull
    and the reference's;
  * ``mesh_gap_mm``: distance between the vertices of the i-th triangles
    of the two meshes, over the triangles both have;
    ``mesh_count_gap``: the difference of their triangle counts.

A plane or hull found on one side only reads ``ONE_SIDED``.
"""

from __future__ import annotations

import re
from pathlib import Path
from typing import Dict, List, NamedTuple

import numpy as np
import torch

from reference import orbit as ref_orbit

NUMBERS = ("pose_gap_mm", "pose_gap_mrad", "cloud_gap_mm", "cloud_count_gap", "plane_gap",
           "hull_gap_mm", "mesh_gap_mm", "mesh_count_gap")
ONE_SIDED = 1.0e3
SURFACE_BLOCK = 64  # X planes a block of the surface extraction
MESH_SLAB = 16  # X cells a slab of the marching tetrahedra (the port's)
K_LOCAL = 96  # candidates a local RANSAC hypothesis (the port's)
F32 = torch.float32


class Settings(NamedTuple):
    """What the export is asked for: the cloud's cap, the downsample,
    RANSAC's rounds, hypotheses, threshold (m) and least inlier share
    (the mesh is always written)."""

    max_points_full: int
    downsample_to: int
    max_planes: int
    n_hypotheses: int
    inlier_threshold: float
    min_inlier_fraction: float


class Room(NamedTuple):
    """A room directory's contents: (N, 3) cloud, (P, 4) planes [n xyz,
    d] (n . x = d), the hulls, (T, 9) mesh triangles and
    the (F, 4, 4) trajectory."""

    cloud: np.ndarray
    planes: np.ndarray
    hulls: List[np.ndarray]
    triangles: np.ndarray
    poses: np.ndarray


# ---------------------------------------------------------------- surface


def surface_points(vol: torch.Tensor, origin: torch.Tensor, vs: torch.Tensor, max_points: int,
                   min_weight: float = 1.0) -> torch.Tensor:
    """(n, 3) world positions of the first ``max_points`` voxels of the
    (2, X, Y, Z) volume whose tsdf changes sign against the +x, +y or +z
    neighbour (both weights >= ``min_weight``), in raster order; each
    moved from its centre by the linear zero crossing along its first
    crossing axis, in priority z, y, x."""
    t_all, w_all = vol[0], vol[1]
    nx, ny, nz = t_all.shape
    out, n_out = [], 0
    for x0 in range(0, nx, SURFACE_BLOCK):
        if n_out >= max_points:
            break
        x1 = min(nx, x0 + SURFACE_BLOCK)
        xe = min(nx, x1 + 1)  # the block and its +x neighbour plane
        t = t_all[x0:xe].float()
        ok = w_all[x0:xe].float() >= min_weight
        sg = torch.sign(t)
        n = x1 - x0
        cx = torch.zeros((n, ny, nz), dtype=torch.bool, device=t.device)
        m = xe - x0 - 1  # planes of the block with a +x neighbour
        cx[:m] = (sg[:m] != sg[1:m + 1]) & ok[:m] & ok[1:m + 1]
        cy = torch.zeros_like(cx)
        cy[:, :-1] = (sg[:n, :-1] != sg[:n, 1:]) & ok[:n, :-1] & ok[:n, 1:]
        cz = torch.zeros_like(cx)
        cz[:, :, :-1] = (sg[:n, :, :-1] != sg[:n, :, 1:]) & ok[:n, :, :-1] & ok[:n, :, 1:]
        loc = torch.nonzero((cx | cy | cz).reshape(-1)).reshape(-1)[: max_points - n_out]
        if loc.numel() == 0:
            continue
        i = loc // (ny * nz)
        j = (loc // nz) % ny
        k = loc % nz
        t_flat = t.reshape(-1)
        t0 = t_flat[loc]

        def alpha(cmask, last, stride, along):
            on = cmask.reshape(-1)[loc]
            t1 = t_flat[torch.where(along < last, loc + stride, loc)]
            a = torch.where((t0 - t1).abs() > 1e-12, t0 / (t0 - t1), 0.5)
            return on, torch.where(on, torch.clamp(a, 0.0, 1.0), 0.0)

        has_z, az = alpha(cz, nz - 1, 1, k)
        has_y, ay = alpha(cy, ny - 1, nz, j)
        _, ax = alpha(cx, nx - 1 - x0, ny * nz, i)
        off_z = torch.where(has_z, az, 0.0)
        off_y = torch.where(~has_z & has_y, ay, 0.0)
        off_x = torch.where(~has_z & ~has_y, ax, 0.0)
        ijk = torch.stack([(i + x0).to(F32) + off_x, j.to(F32) + off_y, k.to(F32) + off_z], -1)
        out.append((ijk + 0.5) * vs + origin)
        n_out += loc.numel()
    if not out:
        return torch.zeros((0, 3), dtype=F32, device=vol.device)
    return torch.cat(out)


def downsample(points: np.ndarray, n: int) -> np.ndarray:
    """``n`` of the points drawn without replacement by
    ``numpy.random.default_rng(0)``; all of them where there are no
    more."""
    if len(points) <= n:
        return points
    return points[np.random.default_rng(0).choice(len(points), n, replace=False)]


# ----------------------------------------------------------------- RANSAC


def _fit_plane(points, weights):
    """Weighted total-least-squares plane: unit normal and d >= 0."""
    w = weights[:, None]
    total = torch.clamp(weights.sum(), min=1e-12)
    mean = (points * w).sum(dim=0) / total
    centered = (points - mean) * torch.sqrt(w)
    _, vecs = torch.linalg.eigh(torch.matmul(centered.T, centered))
    normal = vecs[:, 0]
    d = torch.dot(normal, mean)
    sign = torch.where(d < 0, -1.0, 1.0).to(points.dtype)
    return normal * sign, d * sign


def _hypotheses(points, idx, anchor, cand):
    """Unit normals, d and non-degenerate flags of the hypotheses: random
    triples, then an anchor with its two nearest random candidates."""
    h_loc = anchor.shape[0]
    a_l = points[anchor]
    cpts = points[cand]
    d2 = ((cpts - a_l[:, None]) ** 2).sum(dim=-1)
    d2 = torch.where(d2 < 1e-12, torch.inf, d2)
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
    return normal, (normal * a).sum(dim=1), ok


def ransac(points: torch.Tensor, s: Settings, min_inliers: int):
    """(normals (P, 3), d (P,), planes found, inlier plane of each point)
    on the points' device, accepted planes first."""
    n = points.shape[0]
    dev = points.device
    i32 = torch.int32
    if n < 3:
        return (torch.zeros((s.max_planes, 3), device=dev),
                torch.zeros((s.max_planes,), device=dev), 0,
                torch.full((n,), -1, dtype=i32, device=dev))
    gen = torch.Generator(device=dev).manual_seed(0)
    available = torch.ones((n,), dtype=torch.bool, device=dev)
    inlier_of = torch.full((n,), -1, dtype=i32, device=dev)
    plane_idx = torch.zeros((), dtype=i32, device=dev)
    h_loc = s.n_hypotheses // 2
    normals, ds, accepts = [], [], []
    for _ in range(s.max_planes):
        idx = torch.randint(0, n, (s.n_hypotheses - h_loc, 3), generator=gen, device=dev)
        anchor = torch.randint(0, n, (h_loc,), generator=gen, device=dev)
        cand = torch.randint(0, n, (h_loc, K_LOCAL), generator=gen, device=dev)
        nh, dh, okh = _hypotheses(points, idx, anchor, cand)
        dist = (torch.matmul(nh, points.T) - dh[:, None]).abs()
        inl = (dist < s.inlier_threshold) & available[None, :]
        counts = torch.where(okh, inl.sum(dim=1), 0)
        best = torch.argmax(counts)
        normal, d = _fit_plane(points, inl[best].to(F32))
        final = ((torch.matmul(points, normal) - d).abs() < s.inlier_threshold) & available
        accept = final.sum() >= min_inliers
        available = torch.where(accept, available & ~final, available)
        inlier_of = torch.where(accept & final, plane_idx, inlier_of)
        plane_idx = plane_idx + accept.to(i32)
        normals.append(torch.where(accept, normal, 0.0))
        ds.append(torch.where(accept, d, 0.0))
        accepts.append(accept)
    order = torch.sort((~torch.stack(accepts)).to(i32), stable=True).indices
    return torch.stack(normals)[order], torch.stack(ds)[order], int(plane_idx), inlier_of


def _convex_hull(uv: np.ndarray) -> np.ndarray:
    """Andrew's monotone chain over the distinct 2-D points."""
    pts = np.unique(np.asarray(uv, np.float64), axis=0)
    if len(pts) <= 2:
        return pts
    pts = pts[np.lexsort((pts[:, 1], pts[:, 0]))]

    def chain(seq):
        out: List[np.ndarray] = []
        for p in seq:
            while len(out) >= 2 and ((out[-1][0] - out[-2][0]) * (p[1] - out[-2][1])
                                     - (out[-1][1] - out[-2][1]) * (p[0] - out[-2][0])) <= 0:
                out.pop()
            out.append(p)
        return out

    return np.asarray(chain(pts)[:-1] + chain(pts[::-1])[:-1])


def hulls(points: np.ndarray, normals: np.ndarray, ds: np.ndarray, inlier_of: np.ndarray,
          n_planes: int) -> List[np.ndarray]:
    """Each plane's boundary polygon: its inliers projected onto it, the
    2-D convex hull in the plane's basis, lifted back (float32)."""
    out = []
    for k in range(n_planes):
        n, d = normals[k], ds[k]
        members = points[inlier_of == k]
        if len(members) == 0:
            out.append(np.zeros((0, 3), np.float32))
            continue
        helper = np.array([1.0, 0, 0]) if abs(n[0]) < 0.9 else np.array([0, 1.0, 0])
        e1 = np.cross(n, helper)
        e1 /= np.linalg.norm(e1)
        e2 = np.cross(n, e1)
        proj = members - np.outer(members @ n - d, n)
        hull_uv = _convex_hull(np.stack([proj @ e1, proj @ e2], axis=1))
        out.append((d * n + hull_uv[:, :1] * e1 + hull_uv[:, 1:2] * e2).astype(np.float32))
    return out


# --------------------------------------------------- marching tetrahedra

_CORNERS = ((0, 0, 0), (1, 0, 0), (1, 1, 0), (0, 1, 0), (0, 0, 1), (1, 0, 1), (1, 1, 1), (0, 1, 1))
_TETS = ((0, 1, 2, 6), (0, 2, 3, 6), (0, 3, 7, 6), (0, 7, 4, 6), (0, 4, 5, 6), (0, 5, 1, 6))
_TET_EDGES = ((0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3))


def _tet_cases() -> torch.Tensor:
    """(16, 2, 3) tet-edge ids of each sign case's triangles (-1 pads):
    one corner inside or outside gives one triangle, two give a quad."""
    eid = {}
    for e, (a, b) in enumerate(_TET_EDGES):
        eid[(a, b)] = eid[(b, a)] = e
    table = -torch.ones((16, 2, 3), dtype=torch.int64)
    for case in range(16):
        ins = [c for c in range(4) if case & (1 << c)]
        outs = [c for c in range(4) if not case & (1 << c)]
        if len(ins) == 1:
            tris = [[eid[(ins[0], o)] for o in outs]]
        elif len(ins) == 3:
            tris = [[eid[(outs[0], i)] for i in ins]]
        elif len(ins) == 2:
            q = [eid[(ins[0], outs[0])], eid[(ins[1], outs[0])], eid[(ins[1], outs[1])],
                 eid[(ins[0], outs[1])]]
            tris = [[q[0], q[1], q[2]], [q[0], q[2], q[3]]]
        else:
            tris = []
        for s, tri in enumerate(tris):
            table[case, s] = torch.tensor(tri)
    return table


def _cell_triangles(corner_t, base, origin, vs, cases):
    """(12, M, 9) oriented world triangles of M active cells and (12, M)
    validity, slot = tet * 2 + slot."""
    dev = corner_t[0].device
    verts, valid = [], []
    for tet in _TETS:
        vals = [corner_t[c] for c in tet]
        edge_pts = []
        for a, b in _TET_EDGES:
            va, vb = vals[a], vals[b]
            ca, cb = _CORNERS[tet[a]], _CORNERS[tet[b]]
            denom = vb - va
            big = denom.abs() > 1e-12
            frac = torch.clamp(torch.where(big, -va / torch.where(big, denom, 1.0), 0.5), 0.0, 1.0)
            edge_pts.append(torch.stack(
                [base[k] + ca[k] + frac * (cb[k] - ca[k]) for k in range(3)], -1))
        edge_pts = torch.stack(edge_pts)
        neg = [v < 0 for v in vals]
        bits = (neg[0].to(torch.int64) | (neg[1].to(torch.int64) << 1)
                | (neg[2].to(torch.int64) << 2) | (neg[3].to(torch.int64) << 3))
        neg_f = [m.to(F32) for m in neg]
        neg_n = neg_f[0] + neg_f[1] + neg_f[2] + neg_f[3]
        ref = []
        for k in range(3):
            r = torch.zeros_like(neg_n)
            for local in range(4):
                r = r + (base[k] + _CORNERS[tet[local]][k]) * neg_f[local]
            ref.append(r / torch.clamp(neg_n, min=1.0))
        cells = torch.arange(bits.shape[0], device=dev)
        for slot in range(2):
            tri = cases[bits, slot]
            valid.append(tri[:, 0] >= 0)
            v0, v1, v2 = (edge_pts[torch.clamp(tri[:, v], min=0), cells] for v in range(3))
            e1, e2 = v1 - v0, v2 - v0
            nrm = (e1[:, 1] * e2[:, 2] - e1[:, 2] * e2[:, 1],
                   e1[:, 2] * e2[:, 0] - e1[:, 0] * e2[:, 2],
                   e1[:, 0] * e2[:, 1] - e1[:, 1] * e2[:, 0])
            dot = 0
            for k in range(3):
                dot = dot + nrm[k] * ((v0[:, k] + v1[:, k] + v2[:, k]) / 3.0 - ref[k])
            flip = (dot < 0)[:, None]
            tri_v = torch.cat([v0, torch.where(flip, v2, v1), torch.where(flip, v1, v2)], -1)
            verts.append((tri_v + 0.5) * vs + origin.repeat(3))
    return torch.stack(verts), torch.stack(valid)


def marching_tetrahedra(vol: torch.Tensor, origin: torch.Tensor, vs: torch.Tensor,
                        min_weight: float = 1.0) -> torch.Tensor:
    """(T, 9) zero-isosurface triangles of the (2, X, Y, Z) volume: each
    cell whose 8 corner weights pass ``min_weight`` and whose corners'
    signs differ splits into 6 tetrahedra around its 0-6 diagonal; in
    order X-slab by X-slab (the last clamped to the volume, each slab
    owning its cells from ``i * MESH_SLAB`` on), then triangle slot, then
    cell raster order. Vertices lie on the linear zero crossings of the
    tets' edges, the triangles turned to face from tsdf < 0 to free
    space."""
    t_all, w_all = vol[0], vol[1]
    nx, ny, nz = t_all.shape
    slab = min(MESH_SLAB, nx - 1)
    if slab <= 0:
        return torch.zeros((0, 9), dtype=F32, device=vol.device)
    cases = _tet_cases().to(vol.device)
    out = []
    for i in range(-(-(nx - 1) // slab)):
        x0 = min(i * slab, nx - 1 - slab)
        ts = t_all[x0: x0 + slab + 1].float()
        ws = w_all[x0: x0 + slab + 1].float()
        ok = (ws >= min_weight) & (ws > 0)
        observed = any_neg = all_neg = None
        for dx, dy, dz in _CORNERS:
            sl = (slice(dx, dx + slab), slice(dy, dy + ny - 1), slice(dz, dz + nz - 1))
            c_neg = ts[sl] < 0
            observed = ok[sl] if observed is None else observed & ok[sl]
            any_neg = c_neg if any_neg is None else any_neg | c_neg
            all_neg = c_neg if all_neg is None else all_neg & c_neg
        active = observed & any_neg & ~all_neg
        active[: i * slab - x0] = False
        cx, cy, cz = torch.nonzero(active).unbind(1)
        if cx.numel() == 0:
            continue
        corner_t = [ts[cx + dx, cy + dy, cz + dz] for dx, dy, dz in _CORNERS]
        base = [(cx + x0).to(F32), cy.to(F32), cz.to(F32)]
        verts, valid = _cell_triangles(corner_t, base, origin, vs, cases)
        out.append(verts[valid])
    if not out:
        return torch.zeros((0, 9), dtype=F32, device=vol.device)
    return torch.cat(out)


# ----------------------------------------------------------------- export


@torch.no_grad()
def export(vol: torch.Tensor, config: dict, s: Settings) -> Room:
    """The room directory the reference writes for the (2, R, R, R)
    volume of ``config``'s geometry (the trajectory left empty)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = vol.device
    v = config["volume"]
    res = int(v["resolution"])
    vs = torch.tensor(v["size_m"] / res, dtype=F32, device=dev)
    origin = torch.full((3,), -v["size_m"] / 2.0, dtype=F32, device=dev)
    full = surface_points(vol, origin, vs, s.max_points_full).cpu().numpy()
    down = downsample(full, s.downsample_to)
    min_inliers = max(int(s.min_inlier_fraction * len(down)), 50)
    normals, ds, n_planes, inlier_of = ransac(torch.from_numpy(down).to(dev), s, min_inliers)
    normals, ds = normals.cpu().numpy(), ds.cpu().numpy()
    planes = np.concatenate([normals[:n_planes], ds[:n_planes, None]], axis=1)
    hl = hulls(down, normals, ds, inlier_of.cpu().numpy(), n_planes)
    tris = marching_tetrahedra(vol, origin, vs)
    return Room(full, planes, hl, tris, np.zeros((0, 4, 4), np.float32))


# ------------------------------------------------------ the room on disk


def _binary_body(path: Path, end: bytes):
    raw = bytearray(path.read_bytes())  # writable, so arrays over it are too
    at = raw.index(end) + len(end)
    return raw[:at].decode("ascii"), memoryview(raw)[at:]


def read_pcd(path: Path) -> np.ndarray:
    """(N, 3) float32 points of a binary .pcd holding x, y, z."""
    header, body = _binary_body(Path(path), b"DATA binary\n")
    fields = re.search(r"^FIELDS (.*)$", header, re.M).group(1).split()
    n = int(re.search(r"^POINTS (\d+)$", header, re.M).group(1))
    if fields[:3] != ["x", "y", "z"]:
        raise ValueError(f"{path}: fields {fields}")
    rec = np.frombuffer(body, dtype="<f4", count=n * len(fields)).reshape(n, len(fields))
    return np.ascontiguousarray(rec[:, :3])


def read_ply_triangles(path: Path) -> np.ndarray:
    """(T, 9) float32 triangles of a binary .ply triangle soup (x, y, z
    vertices, faces 3 consecutive vertices each, as the port writes)."""
    header, body = _binary_body(Path(path), b"end_header\n")
    n_v = int(re.search(r"element vertex (\d+)", header).group(1))
    props = re.findall(r"property float (\w+)", header)
    if props[:3] != ["x", "y", "z"] or len(props) != 3:
        raise ValueError(f"{path}: vertex properties {props}")
    verts = np.frombuffer(body, dtype="<f4", count=n_v * 3).reshape(n_v, 3)
    return verts.reshape(-1, 9)


def read_planes_txt(path: Path) -> np.ndarray:
    """(P, 4) [n xyz, d] of planes.txt's ``a b c d`` rows (n . x = -d)."""
    rows = [ln.split() for ln in Path(path).read_text().splitlines() if ln.strip()]
    # nine significant digits give every float32 back exactly
    arr = np.asarray(rows, np.float64).reshape(-1, 4).astype(np.float32)
    arr[:, 3] = -arr[:, 3]
    return arr


def read_trajectory(room: Path) -> np.ndarray:
    """(F, 4, 4) float32 poses of a room directory's trajectory.npz."""
    with np.load(Path(room) / "trajectory.npz") as z:
        return np.asarray(z["poses"], np.float32)


def read_room(room: Path) -> Room:
    room = Path(room)
    planes = read_planes_txt(room / "planes.txt")
    hl = [read_pcd(room / f"cloud_plane_hull{k}.pcd") for k in range(len(planes))]
    return Room(read_pcd(room / "cloud_bin.pcd"), planes, hl, read_ply_triangles(room / "mesh.ply"),
                read_trajectory(room))


def tracked_of(poses: np.ndarray) -> np.ndarray:
    """Each frame's tracked flag, read from a trajectory: a dropped frame
    keeps the previous frame's pose bit for bit (``kinfu_step``), which a
    tracked frame of a moving camera never does; frame 0 is fused at its
    given pose."""
    same = np.all(poses[1:] == poses[:-1], axis=(1, 2))
    return np.concatenate([[True], ~same])


# ----------------------------------------------------------- the numbers


def _prefix_gap(a, b, dev) -> float:
    """Widest distance (mm) between the i-th rows of two (n, 3k) arrays or
    tensors of points, over the rows both have."""
    n = min(len(a), len(b))
    if n == 0:
        return 0.0
    ta = torch.as_tensor(a[:n], device=dev).reshape(n, -1, 3)
    tb = torch.as_tensor(b[:n], device=dev).reshape(n, -1, 3)
    return float((ta.double() - tb.double()).norm(dim=-1).max()) * 1e3


def _hausdorff_mm(a: np.ndarray, b: np.ndarray) -> float:
    if len(a) == 0 or len(b) == 0:
        return 0.0 if len(a) == len(b) else ONE_SIDED
    d = np.linalg.norm(a[:, None, :].astype(np.float64) - b[None, :, :], axis=-1)
    return float(max(d.min(axis=1).max(), d.min(axis=0).max())) * 1e3


def export_numbers(got: Room, want: Room, dev) -> Dict[str, float]:
    """The export's widest gaps of ``got`` (the program's room directory)
    from the reference's ``want``."""
    out = {
        "cloud_gap_mm": _prefix_gap(got.cloud, want.cloud, dev),
        "cloud_count_gap": float(abs(len(got.cloud) - len(want.cloud))),
    }
    n = min(len(got.planes), len(want.planes))
    gap = float(np.abs(got.planes[:n].astype(np.float64) - want.planes[:n]).max()) if n else 0.0
    out["plane_gap"] = ONE_SIDED if len(got.planes) != len(want.planes) else gap
    hgap = [_hausdorff_mm(a, b) for a, b in zip(got.hulls, want.hulls)]
    out["hull_gap_mm"] = ONE_SIDED if len(got.hulls) != len(want.hulls) else max(hgap, default=0.0)
    out["mesh_gap_mm"] = _prefix_gap(got.triangles, want.triangles, dev)
    out["mesh_count_gap"] = float(abs(len(got.triangles) - len(want.triangles)))
    return out


@torch.no_grad()
def check(frames: torch.Tensor, room: Path, init_pose: torch.Tensor, config: dict,
          s: Settings) -> Dict[str, float]:
    """Every number of one scan: the fusion replayed from the room's
    trajectory over ``frames`` ((n, H, W) metres on the device), then the
    replayed volume exported and held to the room directory."""
    got = read_room(room)
    dev = frames.device
    poses = torch.as_tensor(got.poses, device=dev)
    tracked = torch.as_tensor(tracked_of(got.poses), device=dev)
    prog = ref_orbit.PassOut(poses, tracked)
    want = ref_orbit.replay(frames, prog, init_pose, config)
    nums = ref_orbit.numbers(prog, want)  # the poses: ``prog`` holds no volume
    vol = want.volume
    del want
    nums.update(export_numbers(got, export(vol, config, s), dev))
    return nums
