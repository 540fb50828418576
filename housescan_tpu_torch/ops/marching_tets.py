"""K10: the scan's marching-tetrahedra mesh on the card.

``launch_marching_tets`` computes ``kinfu/marching_cubes.marching_cubes``'s
triangle soup for a CUDA volume in one call of three kernels
(``csrc/marching_tets.cu``): the active cells' bitmask and each unit's
slot counts, their scan, then every triangle at its place. The soup is
the plain version's (``marching_cubes_plain``, which runs for CPU
tensors) bit for bit, in its order: by X-slab, then triangle slot, then
cell raster order. The reference has no kernel here (its mesh is XLA
array code); the plain version dispatches about 1,100 small tensor
operations and waits on the card once a slab, which held the scan's
export to the host.

The host waits on the card once, for the triangle count, which sizes the
output; the triangles then come to the host once, through pinned memory.
"""

from __future__ import annotations

import ctypes
import functools
import sys

import numpy as np
import torch

from housescan_tpu_torch.io.ply import Mesh
from housescan_tpu_torch.ops import cuda_lib


@functools.lru_cache(maxsize=None)
def _scratch_bytes(nx: int, ny: int, nz: int, slab: int) -> int:
    out = (ctypes.c_longlong * 1)()
    cuda_lib.check(cuda_lib.load().hs_marching_tets_scratch(nx, ny, nz, slab, out),
                   "hs_marching_tets_scratch")
    return out[0]


def capped(n: int, max_triangles: int) -> int:
    """The triangles a mesh of ``n`` keeps under a nonzero
    ``max_triangles``, saying so on stderr when it cuts."""
    if max_triangles and n > max_triangles:
        print(f"marching_cubes: {n} triangles exceed capacity {max_triangles}; "
              "mesh truncated (raise max_triangles)", file=sys.stderr)
        return max_triangles
    return n


def soup_mesh(tris: np.ndarray) -> Mesh:
    """The host Mesh of a (T, 9) float32 triangle soup: (3T, 3) vertices,
    faces 0..3T-1."""
    vertices = tris.reshape(-1, 3)
    faces = np.arange(len(vertices), dtype=np.int32).reshape(-1, 3)
    return Mesh(vertices=vertices, faces=faces)


def launch_marching_tets(vol, slab: int = 16, min_weight: float = 1.0,
                         max_triangles: int = 0) -> Mesh:
    """K10: ``marching_cubes``' Mesh of a CUDA volume in any layout
    (packed int32, float32 or bfloat16 planes). Raises on a volume it
    does not take, before any launch."""
    layout, (nx, ny, nz) = cuda_lib.volume_layout("marching_tets", vol.data)
    cuda_lib.require_cuda("marching_tets", vol.data, dtype=vol.data.dtype)
    slab = min(slab, nx - 1)
    if slab <= 0 or ny < 2 or nz < 2:
        return soup_mesh(np.zeros((0, 9), np.float32))
    dev = vol.data.device
    params = cuda_lib.f32_vector([vol.origin, vol.voxel_size], dev)
    scratch = torch.empty(_scratch_bytes(nx, ny, nz, slab), dtype=torch.uint8, device=dev)
    total = torch.empty(1, dtype=torch.int64, device=dev)
    cuda_lib.launch("hs_marching_tets_count", dev, vol.data.data_ptr(), layout, nx, ny, nz, slab,
                    float(min_weight), scratch.data_ptr(), total.data_ptr())
    cuda_lib.launch_counts["marching_tets"] += 1
    n = capped(int(total.item()), max_triangles)  # waits for the count, which sizes the output
    host = torch.empty((n, 9), dtype=torch.float32, pin_memory=True)
    if n:
        out = torch.empty((n, 9), dtype=torch.float32, device=dev)
        cuda_lib.launch("hs_marching_tets_emit", dev, vol.data.data_ptr(), layout, nx, ny, nz,
                        slab, params.data_ptr(), scratch.data_ptr(), n, out.data_ptr())
        host.copy_(out)  # waits for the triangles
    return soup_mesh(host.numpy())
