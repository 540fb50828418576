"""The building cell's comparison with the plain reference.

A building is the port's ``scan_building``: every room's recorded stream
fused at its known poses and written to a room directory, then the
assembly of those directories (corners, one cuboid fit a room, the rooms
placed on the grid of floors, their walls connected, their positions
solved, the ``.xf`` files). The reference checks both stages with plain
PyTorch and numpy that import nothing of the program, neither its kernels
nor its room stage (``rooms/``, ``solvers/``):

  * each room, as ``reference/scan.py`` checks a scan: the frames fused
    at the room's known poses with ``reference/step.integrate`` into the
    reference's own volume and planes, then that volume exported with
    ``reference/scan.py``'s ``surface_points``, ``downsample``,
    ``ransac`` and ``hulls`` (same float32 operations in the same order
    as the port: a sound program reads 0 on every room number);
  * the assembly, written here in float64 on the host from the room
    directories' contents, after nh2/housescan (``Main.hs``
    loadRoom :1738-1762, the corner workflow :1484-1545, fitCuboidToRoom
    :1814-1885, connectWalls and optimizeRoomPositions :2039-2168, the
    .xf export :2287-2325; ``FitCuboidBFGS.hs`` :172-252;
    ``TranslationOptimizer.hs``): plane normals turned to face the
    cloud's centroid; corners from every plane triple, a 3x3 solve each,
    kept within 1.2 times the cloud's largest distance from its mean,
    adopted when exactly 8 survive, else the 8 nearest the cloud's
    bounding-box corners (each within 0.1 m, all distinct); the two-stage
    cuboid fit (centre pinned at the corners' mean, then all ten
    parameters free) on the nearest-corner objective with its own
    Nelder-Mead, GSL's NMSimplex2 (reflection, expansion, one contraction
    toward the worst vertex, shrink toward the best; stopped when the
    root-mean-square distance of the vertices from their centroid is
    under 1e-8, or after 2,000 iterations), held to the program by the
    objective it reaches and the cuboid's corners, not by its iterates;
    the rooms on the Cantor grid of floors, each pair of neighbours'
    facing walls connected (a room's ceiling to the floor above it); a
    least-squares solve of the centre offsets a connected group of rooms
    on each axis; each room's transform as its .xf matrix.

Departures from the source, each kept from the port's documented
behaviour (the numbers hold the program to it): the fit runs 8
quaternion starts in its first stage (the source one, its first); a
furnished room's corners are adopted from the bounding box (the source
leaves them to a user's clicks); the 3-D grid and its floors are the
port's (``cantor_slots_3d``; the source places rooms by hand); the
simplex's size is recomputed each iteration (GSL updates it in place);
a room's fusion renders no model maps (a known-pose step tracks nothing
against them, and no file of a room holds them).

Numbers compared (each the widest gap over the rooms):

  * ``cloud_gap_mm``, ``cloud_count_gap``, ``plane_gap``,
    ``hull_gap_mm``: a room directory against the reference's export of
    its own replay, as in the scan cells (``reference/scan.py``);
  * ``corner_gap_mm``: the Hausdorff distance between a room's 8 fitted
    corners (before placement) and the reference's, as point sets;
  * ``fit_rmse_gap_mm``: a room's cuboid rmse against the reference's;
  * ``connection_gap``: wall connections (room pair and axis) found on
    one side only;
  * ``placement_gap_mm``: a room's placed translation against the
    reference's;
  * ``xf_gap``: the largest entry-wise difference of the ``.xf``
    matrices (metres in the translation column).

A fit, corner set or translation found on one side only reads
``ONE_SIDED``.
"""

from __future__ import annotations

import json
from itertools import combinations
from pathlib import Path
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from reference import orbit as ref_orbit
from reference import scan as ref_scan
from reference import step as ref

ROOM_NUMBERS = ("cloud_gap_mm", "cloud_count_gap", "plane_gap", "hull_gap_mm")
ASSEMBLY_NUMBERS = ("corner_gap_mm", "fit_rmse_gap_mm", "connection_gap", "placement_gap_mm",
                    "xf_gap")
NUMBERS = ROOM_NUMBERS + ASSEMBLY_NUMBERS
ONE_SIDED = ref_scan.ONE_SIDED
CUTOFF_FACTOR = 1.2
MAX_SNAP = 0.1
COND_LIMIT = 1e6
NM_TOL, NM_MAX_ITER = 1e-8, 2000
QUAT_STARTS = np.array([[0.1, 0.1, 0.1, 0.1], [0.0, 0.0, 0.0, 1.0], [0.383, 0.0, 0.0, 0.924],
                        [0.0, 0.383, 0.0, 0.924], [0.0, 0.0, 0.383, 0.924],
                        [0.271, 0.271, 0.271, 0.884], [0.5, 0.5, 0.0, 0.707],
                        [0.0, 0.5, 0.5, 0.707]])
SIGNS = np.array([[x, y, z] for x in (-1, 1) for y in (-1, 1) for z in (-1, 1)], np.float64)


class RoomDir(NamedTuple):
    """What the assembly reads of a room directory: the (N, 3)
    downsampled cloud, (P, 4) planes [n xyz, d] (n . x = d) and each
    plane's hull."""

    cloud: np.ndarray
    planes: np.ndarray
    hulls: List[np.ndarray]


# ------------------------------------------------------------- the rooms


@torch.no_grad()
def fuse(frames: torch.Tensor, poses: torch.Tensor, config: dict) -> torch.Tensor:
    """The (2, R, R, R) volume of ``frames`` ((n, H, W) metres on the
    device) fused at ``poses`` ((n, 4, 4)), from an empty volume."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = frames.device
    cam = ref_orbit.cam_of(config)
    v = config["volume"]
    res = int(v["resolution"])
    vs = torch.tensor(v["size_m"] / res, dtype=ref.F32, device=dev)
    origin = torch.full((3,), -v["size_m"] / 2.0, dtype=ref.F32, device=dev)
    trunc = torch.tensor(v["trunc"], dtype=ref.F32, device=dev)
    vol = torch.empty((2, res, res, res), dtype=ref.F32, device=dev)
    vol[0].fill_(1.0)
    vol[1].zero_()
    planes = torch.zeros((res // 8, res // 8, res // 128, 16, 16), dtype=ref.F32, device=dev)
    for j in range(frames.shape[0]):
        ref.integrate(vol, planes, frames[j], poses[j].to(ref.F32), cam, (res, vs, origin, trunc),
                      float(v["max_weight"]))
    return vol


@torch.no_grad()
def export(vol: torch.Tensor, config: dict, s: ref_scan.Settings) -> Tuple[ref_scan.Room, RoomDir]:
    """A room directory's files from the volume, as the port writes them
    without a mesh: (the full cloud, planes and hulls as a
    ``reference/scan.Room``; what the assembly reads)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = vol.device
    v = config["volume"]
    res = int(v["resolution"])
    vs = torch.tensor(v["size_m"] / res, dtype=ref.F32, device=dev)
    origin = torch.full((3,), -v["size_m"] / 2.0, dtype=ref.F32, device=dev)
    full = ref_scan.surface_points(vol, origin, vs, s.max_points_full).cpu().numpy()
    down = ref_scan.downsample(full, s.downsample_to)
    min_inliers = max(int(s.min_inlier_fraction * len(down)), 50)
    normals, ds, n_planes, inlier_of = ref_scan.ransac(torch.from_numpy(down).to(dev), s,
                                                       min_inliers)
    normals, ds = normals.cpu().numpy(), ds.cpu().numpy()
    planes = np.concatenate([normals[:n_planes], ds[:n_planes, None]], axis=1)
    hl = ref_scan.hulls(down, normals, ds, inlier_of.cpu().numpy(), n_planes)
    none = np.zeros((0, 9), np.float32)
    return (ref_scan.Room(full, planes, hl, none, np.zeros((0, 4, 4), np.float32)),
            RoomDir(down, planes, hl))


def read_room(room: Path) -> Tuple[ref_scan.Room, RoomDir]:
    """A room directory written without a mesh, as ``export`` returns it."""
    room = Path(room)
    planes = ref_scan.read_planes_txt(room / "planes.txt")
    hl = [ref_scan.read_pcd(room / f"cloud_plane_hull{k}.pcd") for k in range(len(planes))]
    none = np.zeros((0, 9), np.float32)
    full = ref_scan.Room(ref_scan.read_pcd(room / "cloud_bin.pcd"), planes, hl, none,
                         ref_scan.read_trajectory(room))
    return full, RoomDir(ref_scan.read_pcd(room / "cloud_downsampled.pcd"), planes, hl)


def room_numbers(got: ref_scan.Room, want: ref_scan.Room, dev) -> Dict[str, float]:
    nums = ref_scan.export_numbers(got, want, dev)
    return {k: nums[k] for k in ROOM_NUMBERS}


# ---------------------------------------------------------- the assembly


class Placed(NamedTuple):
    """The reference's building: by room name, the fitted corners (8, 3)
    before placement, the fit's rmse (m), the placed translation (3,);
    and the wall connections as (room a, room b, axis)."""

    corners: Dict[str, np.ndarray]
    rmse: Dict[str, float]
    translation: Dict[str, np.ndarray]
    connections: List[Tuple[str, str, int]]


def _inward(d: RoomDir) -> Tuple[np.ndarray, np.ndarray]:
    """Unit normals (P, 3) and offsets (P,) of a room's planes, each
    turned to face the cloud's centroid (``loadRoom``)."""
    pl = d.planes.astype(np.float64)
    norm = np.linalg.norm(pl[:, :3], axis=1)
    n, off = pl[:, :3] / norm[:, None], pl[:, 3] / norm
    centre = d.cloud.astype(np.float64).mean(axis=0)
    for k, h in enumerate(d.hulls):
        mean = h.astype(np.float64).mean(axis=0) if len(h) else np.full(3, np.nan)
        if not float(np.dot(centre - mean, n[k])) > 0:
            n[k], off[k] = -n[k], -off[k]
    return n, off


def corners_of(d: RoomDir) -> Optional[np.ndarray]:
    """The room's 8 corners in the order the room stage holds them, or
    None: every plane triple's intersection within the cutoff; exactly 8
    are taken as they come, more give the 8 nearest the cloud's
    bounding-box corners, each adopted in front of the last."""
    n, off = _inward(d)
    if len(n) < 3:
        return None
    cloud = d.cloud.astype(np.float64)
    mean = cloud.mean(axis=0)
    cutoff = CUTOFF_FACTOR * float(np.linalg.norm(cloud - mean, axis=1).max())
    kept = []
    for tri in combinations(range(len(n)), 3):
        m = n[list(tri)]
        if not abs(float(np.linalg.det(m))) > 1.0 / COND_LIMIT:
            continue
        x = np.linalg.solve(m, off[list(tri)])
        if float(np.linalg.norm(x - mean)) <= cutoff:
            kept.append(x)
    if len(kept) == 8:
        return np.stack(kept)
    if len(kept) < 8:
        return None
    lo, hi = cloud.min(axis=0), cloud.max(axis=0)
    chosen = []
    for sx in (0, 1):
        for sy in (0, 1):
            for sz in (0, 1):
                target = np.array([(lo[0], hi[0])[sx], (lo[1], hi[1])[sy], (lo[2], hi[2])[sz]])
                dist = [float(np.linalg.norm(k - target)) for k in kept]
                best = int(np.argmin(dist))
                if dist[best] > MAX_SNAP:
                    return None
                chosen.append(best)
    if len(set(chosen)) != 8:
        return None
    return np.stack([kept[i] for i in reversed(chosen)])


def _rotation(q: np.ndarray) -> np.ndarray:
    """(..., 3, 3) row-vector rotation (``p @ R``) of the quaternion
    (x, y, z, w), normalised first."""
    q = q / np.linalg.norm(q, axis=-1, keepdims=True)
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    col = np.stack([
        np.stack([1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)], -1),
        np.stack([2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)], -1),
        np.stack([2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)], -1),
    ], -2)
    return np.swapaxes(col, -1, -2)


def cuboid(params: np.ndarray) -> np.ndarray:
    """(..., 8, 3) corners of (..., 10) parameters: centre, dimensions,
    quaternion."""
    local = SIGNS * (params[..., None, 3:6] / 2.0)
    return local @ _rotation(params[..., 6:10]) + params[..., None, 0:3]


def _nearest_sq(points: np.ndarray, corners: np.ndarray) -> np.ndarray:
    """Sum over (..., 8, 3) ``points`` of the squared distance to the
    nearest of (..., 8, 3) ``corners``."""
    d2 = ((points[..., :, None, :] - corners[..., None, :, :]) ** 2).sum(-1)
    return d2.min(-1).sum(-1)


def nmsimplex2(f, x0: np.ndarray, steps: np.ndarray, tol: float = NM_TOL,
               max_iter: int = NM_MAX_ITER) -> Tuple[np.ndarray, np.ndarray]:
    """GSL's NMSimplex2 on B problems at once: ``f`` maps (B, K, n)
    points to (B, K) values; starts (B, n), axis steps (B, n). Each
    problem stops on its own. Returns (best x (B, n), best f (B,))."""
    b, n = x0.shape
    p = n + 1
    rows = np.arange(b)
    x = np.concatenate([x0[:, None], x0[:, None] + steps[:, :, None] * np.eye(n)[None]], 1)
    y = f(x)
    active = np.ones(b, bool)

    for _ in range(max_iter):
        if not active.any():
            break
        # highest, second highest and lowest vertex, scanned as GSL does
        dhi, dlo = y[:, 0].copy(), y[:, 0].copy()
        hi, lo = np.zeros(b, int), np.zeros(b, int)
        ds_hi, s_hi = y[:, 1].copy(), np.ones(b, int)
        for i in range(1, p):
            val = y[:, i]
            c_lo = val < dlo
            c_hi = ~c_lo & (val > dhi)
            c_s = ~c_lo & ~c_hi & (val > ds_hi)
            dlo, lo = np.where(c_lo, val, dlo), np.where(c_lo, i, lo)
            ds_hi = np.where(c_hi, dhi, np.where(c_s, val, ds_hi))
            s_hi = np.where(c_hi, hi, np.where(c_s, i, s_hi))
            dhi, hi = np.where(c_hi, val, dhi), np.where(c_hi, i, hi)
        x_hi = x[rows, hi]
        mid = (x.sum(1) - x_hi) / n  # centroid of the other vertices

        def corner_move(coeff, corner):
            return (1.0 - coeff) * mid + coeff * corner

        refl, expd = corner_move(-1.0, x_hi), corner_move(-2.0, x_hi)
        v = f(np.stack([refl, expd], 1))
        v_r, v_e = v[:, 0], v[:, 1]
        fin_r, fin_e = np.isfinite(v_r), np.isfinite(v_e)
        y_lo, y_hi, y_shi = y[rows, lo], y[rows, hi], y[rows, s_hi]
        expand_branch = fin_r & (v_r < y_lo)
        contract_branch = ~expand_branch & (~fin_r | (v_r > y_shi))
        take_refl = (expand_branch & ~(fin_e & (v_e < y_lo))) | (~expand_branch & ~contract_branch)
        take_exp = expand_branch & fin_e & (v_e < y_lo)
        # the contraction branch first puts the reflection in place of the
        # worst vertex where it is no worse, then contracts that vertex
        keep_refl = contract_branch & fin_r & (v_r <= y_hi)
        new_hi = np.where(keep_refl[:, None], refl, x_hi)
        new_yhi = np.where(keep_refl, v_r, y_hi)
        contr = corner_move(0.5, new_hi)
        v_c = f(contr[:, None])[:, 0]
        take_contr = contract_branch & np.isfinite(v_c) & (v_c <= new_yhi)
        shrink = contract_branch & ~take_contr

        nx, ny = x.copy(), y.copy()
        upd = take_refl | take_exp | keep_refl | take_contr
        point = np.where(take_exp[:, None], expd, np.where(take_contr[:, None], contr, refl))
        value = np.where(take_exp, v_e, np.where(take_contr, v_c, v_r))
        nx[rows[upd], hi[upd]] = point[upd]
        ny[rows[upd], hi[upd]] = value[upd]
        if shrink.any():
            best = nx[rows, lo][:, None]
            sh = 0.5 * (nx + best)
            sh[rows, lo] = nx[rows, lo]
            sv = f(sh)
            sv[rows, lo] = ny[rows, lo]
            nx = np.where(shrink[:, None, None], sh, nx)
            ny = np.where(shrink[:, None], sv, ny)
        x = np.where(active[:, None, None], nx, x)
        y = np.where(active[:, None], ny, y)
        centre = x.mean(1, keepdims=True)
        size = np.sqrt((((x - centre) ** 2).sum(-1)).mean(-1))
        active &= ~(size < tol)

    best = np.argmin(y, axis=1)
    return x[rows, best], y[rows, best]


def fit_cuboids(points: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Two-stage fits of (R, 8, 3) corner sets: (params (R, 10), the
    nearest-corner objective (R,))."""
    r = len(points)
    centre = points.mean(axis=1)
    edge = np.sort(np.linalg.norm(points[:, 1:] - points[:, :1], axis=-1), axis=-1)[:, 0]
    s = len(QUAT_STARTS)
    x0 = np.concatenate([np.repeat(edge[:, None, None], 3, 2).repeat(s, 1),
                         np.broadcast_to(QUAT_STARTS, (r, s, 4))], -1).reshape(r * s, 7)
    steps = np.concatenate([np.repeat(edge[:, None] / 10.0, 3, 1), np.full((r, 4), 0.1)], 1)
    c_rep, p_rep = np.repeat(centre, s, 0), np.repeat(points, s, 0)

    def pinned(x):
        full = np.concatenate([np.broadcast_to(c_rep[:, None], x.shape[:-1] + (3,)), x], -1)
        return _nearest_sq(p_rep[:, None], cuboid(full))

    x1, f1 = nmsimplex2(pinned, x0, np.repeat(steps, s, 0))
    best = np.argmin(f1.reshape(r, s), axis=1)
    stage1 = np.concatenate([centre, x1.reshape(r, s, 7)[np.arange(r), best]], 1)
    steps2 = np.concatenate([np.full((r, 3), 0.01), np.repeat(edge[:, None] / 10.0, 3, 1),
                             np.full((r, 4), 0.1)], 1)
    return nmsimplex2(lambda x: _nearest_sq(points[:, None], cuboid(x)), stage1, steps2)


def _faces(params: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """The six faces of a cuboid in the room stage's order (the +x face
    with normal -x, the -x face with +x, then y, then z): inward unit
    normals (6, 3) and centres (6, 3)."""
    rot = _rotation(params[6:10])
    normals, centres = [], []
    for k in range(3):
        for s in (1.0, -1.0):
            normals.append(-s * rot[k])
            centres.append(params[0:3] + s * params[3 + k] / 2.0 * rot[k])
    return np.stack(normals), np.stack(centres)


def slots(n: int, floors: Sequence[int]) -> List[Tuple[int, int, int]]:
    """(gx, floor, gz) of each of ``n`` rooms: floors filled bottom up,
    each in the Cantor-diagonal order (0, 0), (1, 0), (0, 1), (2, 0), ..."""
    out = []
    for fl, count in enumerate(floors):
        cells, d = [], 0
        while len(cells) < count:
            cells += [(d - i, i) for i in range(d + 1)]
            d += 1
        for gx, gz in cells[:min(count, n - len(out))]:
            out.append((gx, fl, gz))
    return out[:n]


def _components(edges: List[Tuple[Tuple[str, str], float]]):
    """Connected groups of (pair, offset) edges, in the order their first
    edges come, each edge in its own order."""
    root: Dict[str, str] = {}

    def find(a):
        while root.setdefault(a, a) != a:
            a = root[a]
        return a

    for (a, b), _ in edges:
        ra, rb = find(a), find(b)
        if ra != rb:
            root[rb] = ra
    groups: Dict[str, list] = {}
    for e in edges:
        groups.setdefault(find(e[0][0]), []).append(e)
    return list(groups.values())


def assemble(rooms: Sequence[Tuple[str, RoomDir]], floors: Sequence[int], spacing: float,
             gap: float) -> Placed:
    """The reference's building of the room directories ``rooms`` (name,
    contents, in scan order) on the grid of ``floors``."""
    names = [nm for nm, _ in rooms]
    corners = {nm: corners_of(d) for nm, d in rooms}
    fit_names = [nm for nm in names if corners[nm] is not None]
    fit_corners, rmse, faces = {}, {}, {}
    if fit_names:
        params, err = fit_cuboids(np.stack([corners[nm] for nm in fit_names]))
        for k, nm in enumerate(fit_names):
            fit_corners[nm] = cuboid(params[k])
            rmse[nm] = float(np.sqrt(err[k]))
            faces[nm] = _faces(params[k])
    at = dict(zip(slots(len(names), floors), names))
    trans = {nm: np.array([gx * spacing, -fl * spacing, gz * spacing], np.float64)
             for (gx, fl, gz), nm in at.items()}
    conns: List[Tuple[str, str, int]] = []

    def connect(a, b, axis):
        """a's wall facing +axis to b's facing -axis (inward normals)."""
        if a not in faces or b not in faces:
            return
        na, nb = faces[a][0], faces[b][0]
        ca = [k for k in range(6) if int(np.argmax(np.abs(na[k]))) == axis]
        cb = [k for k in range(6) if int(np.argmax(np.abs(nb[k]))) == axis]
        if not ca or not cb:
            return
        ka = min(ca, key=lambda k: na[k][axis])
        kb = max(cb, key=lambda k: nb[k][axis])
        conns.insert(0, (a, b, axis, ka, kb))

    for (gx, fl, gz), nm in at.items():
        for dx, dz, axis in ((1, 0, 0), (0, 1, 2)):
            other = at.get((gx + dx, fl, gz + dz))
            if other is not None:
                connect(nm, other, axis)
        above = at.get((gx, fl + 1, gz))
        if above is not None:
            connect(above, nm, 1)

    for axis in range(3):
        edges, firsts = [], []
        for a, b, ax, ka, kb in conns:
            if ax != axis:
                continue
            ma, mb = fit_corners[a].mean(axis=0), fit_corners[b].mean(axis=0)
            o = (faces[a][1][ka][axis] - ma[axis]) - (faces[b][1][kb][axis] - mb[axis])
            edges.append(((a, b), o + float(np.sign(o)) * gap))
            firsts.append(a)
        if not edges:
            continue
        # every group is placed against the first connection's first room,
        # where it stood before this axis was solved
        first = firsts[0]
        anchor = fit_corners[first].mean(axis=0)[axis] + trans[first][axis]
        for comp in _components(edges):
            dist = dict(comp)
            nodes = list(dict.fromkeys(n for pair in dist for n in pair))
            ix = {nd: i for i, nd in enumerate(nodes)}
            a_full = np.zeros((len(dist), len(nodes)))
            for e, (i, j) in enumerate(dist):
                a_full[e, ix[i]] -= 1.0
                a_full[e, ix[j]] += 1.0
            a_mat = a_full[:, 1:]
            if len(nodes) > 1 and np.linalg.matrix_rank(a_mat) < len(nodes) - 1:
                continue
            sol = np.linalg.lstsq(a_mat, np.array(list(dist.values())), rcond=None)[0]
            pos = np.concatenate([[0.0], sol])
            for nd, x in zip(nodes, pos):
                current = fit_corners[nd].mean(axis=0)[axis] + trans[nd][axis]
                trans[nd][axis] += (x + anchor) - current
    return Placed(fit_corners, rmse, trans, [(a, b, ax) for a, b, ax, _, _ in conns])


def xf_matrix(translation: np.ndarray) -> np.ndarray:
    """The .xf matrix (column-vector convention) of a room moved by
    ``translation`` and not turned."""
    m = np.eye(4)
    m[:3, 3] = translation
    return m


def read_xf(path: Path) -> np.ndarray:
    return np.asarray([float(t) for t in Path(path).read_text().split()], np.float64).reshape(4, 4)


# ----------------------------------------------------------- the numbers


class ProgramBuilding(NamedTuple):
    """The program's building, as the driver reads it from what
    ``scan_building`` returned and wrote: by room name, the fitted
    corners (8, 3) before placement, the placed translation (3,); the
    wall connections (room a, room b, axis); the building directory."""

    corners: Dict[str, np.ndarray]
    translation: Dict[str, np.ndarray]
    connections: List[Tuple[str, str, int]]
    out: Path


def _hausdorff_mm(a: np.ndarray, b: np.ndarray) -> float:
    d = np.linalg.norm(a[:, None, :].astype(np.float64) - b[None, :, :], axis=-1)
    return float(max(d.min(axis=1).max(), d.min(axis=0).max())) * 1e3


def assembly_numbers(got: ProgramBuilding, want: Placed, names: Sequence[str]) -> Dict[str, float]:
    """The assembly's widest gaps of the program's building from the
    reference's."""
    rmse = json.loads((got.out / "building_checkpoint.json").read_text()).get("fit_rmse", {})
    corner, fit, place, xf = 0.0, 0.0, 0.0, 0.0
    for nm in names:
        g, w = got.corners.get(nm), want.corners.get(nm)
        if (g is None) != (w is None) or (nm in rmse) != (nm in want.rmse):
            corner = fit = ONE_SIDED
        elif g is not None:
            corner = max(corner, _hausdorff_mm(g, w))
            fit = max(fit, abs(rmse[nm] - want.rmse[nm]) * 1e3)
        place = max(place, float(np.linalg.norm(got.translation[nm] - want.translation[nm])) * 1e3)
        path = got.out / "xf" / f"{nm}.xf"
        xf = ONE_SIDED if not path.exists() else max(
            xf, float(np.abs(read_xf(path) - xf_matrix(want.translation[nm])).max()))
    conn = len(set(got.connections) ^ set(want.connections))
    return {"corner_gap_mm": corner, "fit_rmse_gap_mm": fit, "connection_gap": float(conn),
            "placement_gap_mm": place, "xf_gap": xf}


@torch.no_grad()
def check(frames: Dict[str, np.ndarray], poses: np.ndarray, got: ProgramBuilding,
          names: Sequence[str], replay: Sequence[str], config: dict, s: ref_scan.Settings,
          floors: Sequence[int], spacing: float, gap: float, device) -> Dict[str, float]:
    """Every number of one building: the rooms of ``replay`` (their host
    frames, in metres, fused at ``poses`` on ``device``) fused and
    exported by the reference and held to the program's room directories;
    then the reference's assembly of its own directories for those rooms
    and of the program's for the rest, held to the program's building."""
    nums = {k: 0.0 for k in ROOM_NUMBERS}
    pose_t = torch.as_tensor(poses, dtype=ref.F32, device=device)
    dirs = []
    for nm in names:
        program_room, program_dir = read_room(got.out / nm)
        if nm in replay:
            vol = fuse(torch.from_numpy(frames[nm]).to(device), pose_t, config)
            want_room, want_dir = export(vol, config, s)
            del vol
            for k, v in room_numbers(program_room, want_room, device).items():
                nums[k] = max(nums[k], v)
            dirs.append((nm, want_dir))
        else:
            dirs.append((nm, program_dir))
    nums.update(assembly_numbers(got, assemble(dirs, floors, spacing, gap), names))
    return nums
