"""K3's work for one frame: every ICP pyramid level's maps read once.

Per level l of an (H, W) frame the level holds (H >> l) x (W >> l)
pixels, and each pixel's 19 float32 map rows (live vertex and normal,
model vertex and normal, model valid, the model's two vertex gradients)
are read once: the least the level's iterations can move. Operations:
196 float operations for each pixel with a live depth (the pose
transforms, the projection, the association along the gradients, the
distance and angle gates, the Huber and incidence weights, the 28
products of the normal equations and their sums), counted for one
iteration a level: the early exit makes the rest depend on
convergence, which the data alone does not give, so the operation count
is a floor and the bound can only come out low, never high.
"""

from __future__ import annotations

N_ROWS = 19
OPS_PER_PIXEL = 196


def frame_work(depth, levels: int = 3):
    """(bytes, ops) of K3 over one frame's levels; ``depth`` is the
    (H, W) frame (0 = no depth)."""
    h, w = depth.shape
    n_bytes = 0
    n_ops = 0
    for lvl in range(levels):
        s = 1 << lvl
        n_bytes += N_ROWS * 4 * (h // s) * (w // s)
        n_ops += OPS_PER_PIXEL * int((depth[: (h // s) * s: s, : (w // s) * s: s] > 0).sum())
    return n_bytes, n_ops
