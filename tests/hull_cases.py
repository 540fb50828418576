"""The plane hulls' test cases: 2D float64 point sets for Andrew's
monotone chain, shared by the CPU tests of the Python chain
(``tests/test_torch_scan.py``, which hold it to the reference's chain byte
for byte) and the card tests of the compiled chain
(``tests/test_torch_gpu.py``, which hold it to the Python chain byte for
byte), so both paths face one set of cases.

Each case is made from its own seed; ``CASES`` names them.
"""

import numpy as np

VOXEL = 3.0 / 512  # PCL KinFu's 5.86 mm voxel


def _wall(n, seed):
    """n points of a wall on a 5.86 mm lattice (a 2.6 x 2.4 m rectangle
    with a door and a window cut out), turned by a random angle and
    rounded through float32, as a plane's projected inliers are."""
    rng = np.random.default_rng(seed)
    ij = np.stack(np.meshgrid(np.arange(444), np.arange(410), indexing="ij"), -1).reshape(-1, 2)
    uv = ij * VOXEL
    door = (uv[:, 0] > 0.4) & (uv[:, 0] < 1.2) & (uv[:, 1] < 2.0)
    window = (uv[:, 0] > 1.6) & (uv[:, 0] < 2.3) & (uv[:, 1] > 0.9) & (uv[:, 1] < 1.8)
    uv = uv[~door & ~window]
    uv = uv[rng.choice(len(uv), n, replace=False)]
    a = rng.uniform(0, 2 * np.pi)
    rot = np.array([[np.cos(a), -np.sin(a)], [np.sin(a), np.cos(a)]])
    return (uv @ rot.T + rng.uniform(-3, 3, 2)).astype(np.float32).astype(np.float64)


def _uniform(n, seed):
    return np.random.default_rng(seed).uniform(-1.0, 1.0, (n, 2))


def _disk(n, seed):
    """n points inside a unit disk, a hundred of them on its circle: a
    large hull."""
    rng = np.random.default_rng(seed)
    r = np.sqrt(rng.uniform(0, 1, n))
    r[:100] = 1.0
    t = rng.uniform(0, 2 * np.pi, n)
    return np.stack([r * np.cos(t), r * np.sin(t)], 1)


def _duplicates(seed):
    """600 rows drawn from 40 distinct points: every hull vertex repeated."""
    rng = np.random.default_rng(seed)
    base = rng.uniform(-1.0, 1.0, (40, 2))
    return base[rng.integers(0, 40, 600)]


def _signed_zeros():
    """Rows that differ only by the sign of a zero, on the hull and inside
    it, each sign first in turn."""
    z, m = 0.0, -0.0
    return np.array([
        [z, z], [m, z], [z, m], [m, m],
        [1.0, z], [1.0, m], [m, 1.0], [z, 1.0], [1.0, 1.0],
        [0.5, z], [0.5, m], [m, 0.5], [z, 0.5], [0.5, 0.5],
        [-1.0, m], [-1.0, z], [m, -1.0], [z, -1.0],
    ])


def _lone_negative_zeros():
    """-0.0 with no +0.0 beside it, in both coordinates."""
    return np.array([[-0.0, 2.0], [3.0, -0.0], [-0.0, -0.0], [1.0, 1.0], [2.0, 3.0], [-1.0, 0.5]])


def _collinear_runs():
    """An integer square's boundary, every lattice point on its edges
    (horizontal and vertical runs), a diagonal through it and its inside."""
    k = np.arange(11.0)
    zero, ten = np.zeros(11), np.full(11, 10.0)
    edges = [np.stack(p, 1) for p in ((k, zero), (k, ten), (zero, k), (ten, k), (k, k), (k, 10 - k))]
    inside = np.stack(np.meshgrid(k[2:9], k[3:8]), -1).reshape(-1, 2)
    return np.concatenate(edges + [inside])


def _diagonal_hull():
    """A diamond whose four edges are exact diagonal runs."""
    k = np.arange(9.0)
    return np.concatenate([np.stack(p, 1) for p in (
        (k, 8 - k), (k + 8, k), (16 - k, 8 + k), (8 - k, 16 - k))])


def _near_collinear(seed):
    """Triples along random lines with the middle point one ulp off the
    line's computed y, up and down, between two hull corners."""
    rng = np.random.default_rng(seed)
    rows = []
    for _ in range(60):
        x0, x1 = np.sort(rng.uniform(-1.0, 1.0, 2))
        y0, slope = rng.uniform(-1.0, 1.0, 2)
        xm = rng.uniform(x0, x1)
        ym = y0 + slope * (xm - x0)
        for y in (ym, np.nextafter(ym, np.inf), np.nextafter(ym, -np.inf)):
            rows += [[x0, y0], [xm, y], [x1, y0 + slope * (x1 - x0)]]
    return np.array(rows)


def _ulp_lattice(seed):
    """A small lattice with every other point moved by one ulp."""
    rng = np.random.default_rng(seed)
    p = np.stack(np.meshgrid(np.arange(12.0), np.arange(9.0)), -1).reshape(-1, 2) * 0.1
    up = rng.integers(0, 2, p.shape).astype(bool)
    return np.where(up, np.nextafter(p, np.inf), p)


def _all_collinear():
    t = np.random.default_rng(7).uniform(0, 1, 300)
    return np.stack([0.25 + 3 * t, -1 + 3 * t], 1)


def _integer_lattice(seed):
    """A random subset of a small integer grid: exact collinear runs."""
    rng = np.random.default_rng(seed)
    g = np.stack(np.meshgrid(np.arange(10.0), np.arange(7.0)), -1).reshape(-1, 2)
    return g[rng.random(len(g)) < rng.uniform(0.1, 0.5)]


def room_cloud(n=8000, seed=0):
    """(n, 3) float32 points of a 2.6 x 2.4 x 2.4 m room's floor and three
    walls, on the 5.86 mm lattice with 1 mm of noise across each face:
    a cloud that RANSAC splits into four planes."""
    rng = np.random.default_rng(seed)
    size = np.array([2.6, 2.4, 2.4])
    face = rng.integers(0, 4, n)  # floor y = 0, walls x = 0, z = 0, x = 2.6
    axis = np.array([1, 0, 2, 0])[face]
    p = np.round(rng.uniform(0, 1, (n, 3)) * size / VOXEL) * VOXEL
    p[np.arange(n), axis] = np.where(face == 3, size[0], 0.0) + rng.normal(0, 1e-3, n)
    return p.astype(np.float32)


CASES = {
    "empty": lambda: np.zeros((0, 2)),
    "one": lambda: np.array([[0.5, -0.25]]),
    "two": lambda: np.array([[1.0, 2.0], [-1.0, 0.5]]),
    "three": lambda: np.array([[0.0, 0.0], [1.0, 0.0], [0.0, 1.0]]),
    "three_collinear": lambda: np.array([[0.0, 0.0], [2.0, 2.0], [1.0, 1.0]]),
    "wall_3000": lambda: _wall(3000, 1),
    "wall_8000": lambda: _wall(8000, 2),
    "wall_20000": lambda: _wall(20000, 3),
    "uniform_1000": lambda: _uniform(1000, 4),
    "uniform_10000": lambda: _uniform(10000, 5),
    "disk_5000": lambda: _disk(5000, 6),
    "duplicates": lambda: _duplicates(8),
    "signed_zeros": _signed_zeros,
    "lone_negative_zeros": _lone_negative_zeros,
    "collinear_runs": _collinear_runs,
    "diagonal_hull": _diagonal_hull,
    "near_collinear": lambda: _near_collinear(9),
    "ulp_lattice": lambda: _ulp_lattice(10),
    "all_collinear": _all_collinear,
    **{f"integer_lattice_{s}": (lambda s=s: _integer_lattice(100 + s)) for s in range(20)},
}
