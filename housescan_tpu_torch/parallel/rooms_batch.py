"""Rooms fitted in parallel over a mesh (``housescan_tpu/parallel/
rooms_batch.py``): the batch of corner sets split into one part a device,
each part one ``solvers.fit_cuboid_batch`` loop."""

from __future__ import annotations

import torch

from housescan_tpu_torch.parallel.mesh import Mesh
from housescan_tpu_torch.solvers.cuboid_fit import CuboidFit, fit_cuboid_batch


def fit_cuboids_sharded(corners_batch, mesh: Mesh, tol: float = 1e-8,
                        max_iter: int = 2000) -> CuboidFit:
    """Fit cuboids to a (B, 8, 3) batch, cut into contiguous parts over
    the mesh's devices (at most one part a device; B need not divide the
    mesh: an instance's fit does not depend on the others of its loop, so
    any cut gives the same fits). The fits come back in batch order on
    the first device."""
    batch = torch.as_tensor(corners_batch, dtype=torch.float32)
    parts = torch.tensor_split(batch, min(mesh.size, batch.shape[0]))
    dev0 = mesh.devices[0]
    fits = [fit_cuboid_batch(part, tol=tol, max_iter=max_iter, device=dev)
            for part, dev in zip(parts, mesh.devices)]
    return CuboidFit(*(torch.cat([getattr(f, k).to(dev0) for f in fits])
                       for k in CuboidFit._fields))
