"""K7: the whole-volume sub-block plane extraction.

Replaces ``housescan_tpu/ops/planes_pallas.py:_kernel`` (line 372, called
at :405 by ``extract_subblock_planes``, :386). ``extract_subblock_planes``
fits the 16 sub-block planes of every (8, 8, 128) chunk of the volume
(``ops/planes.py``) into the persistent layout that K4 refreshes and K6
reads, (X/8, Y/8, Z/128, 16, 16). Unlike K4's refit it writes every field
of every chunk, also where no plane can be valid (count, id, radius,
centroid, lambda_min); field 11 stays 0. A packed volume is fitted on its
decoded values, as the reference fits ``vol.tsdf`` / ``vol.weight``.

It is off the fusion step: ``raycast_planes.raycast_pallas`` (model maps
straight from a volume) calls it, and it is the oracle K4's planes are
held to.

CUDA kernel, ``csrc/planes_extract.cu``, weights first: one launch of a
persistent grid (two 256-thread blocks an SM, chunks claimed from a
counter) streams each chunk's weight plane (packed: its cells) through a
ring of shared-memory buffers with bulk copies; a chunk with no observed
voxel writes its tile from the all-zero moments' shape, and an observed
one fetches the tsdf of its observed 8-voxel z-segments only, then a
warp fits each observed sub-block that has a voxel below 0.99 (which
every moment term needs) with the device fit of ``csrc/planes.cuh`` that
K4 and K8 inline. Bound: device-memory bytes, every weight read (4
bytes a voxel; packed: every cell), the tsdf of the observed voxels and
each planes tile written once: at dense-512 (~2% observed) ~0.17 ms at
3.35 TB/s; ``chip_smoke.py`` counts it from the volume's data.
"""

from __future__ import annotations

import torch

from housescan_tpu_torch.kinfu.tsdf import TsdfVolume, read_tw
from housescan_tpu_torch.ops import cuda_lib
from housescan_tpu_torch.ops.planes import N_FIELDS, NSUB_C, chunk_plane_fields
from housescan_tpu_torch.ops.tsdf_stream import (
    CHUNK_Z, PLAIN_BATCH, _card, _layout_key, chunk_cells, planes_shape, stream_grid,
)


def _extract_params(vol: TsdfVolume, min_count: float, nbx: int) -> torch.Tensor:
    return cuda_lib.f32_vector([vol.voxel_size, vol.origin, min_count, nbx], vol.data.device)


def extract_planes_plain(data: torch.Tensor, params: torch.Tensor) -> torch.Tensor:
    """K7's plain version: every chunk of ``data`` (either layout) in
    batches; ``params`` = (voxel size, origin x, y, z, min_count, nbx)."""
    _, (nx, ny, nz) = cuda_lib.volume_layout("planes_extract", data)
    nbx, nby, nzc = nx // 8, ny // 8, nz // CHUNK_Z
    vs, ox, oy, oz, min_count = (params[k] for k in range(5))
    out = torch.empty((nbx * nby * nzc, N_FIELDS, NSUB_C), dtype=torch.float32, device=data.device)
    ids = torch.arange(nbx * nby * nzc, device=data.device)
    for s in range(0, ids.shape[0], PLAIN_BATCH):
        c = ids[s : s + PLAIN_BATCH]
        ci, cj, ck = c // (nby * nzc), (c // nzc) % nby, c % nzc
        t, w = read_tw(data, chunk_cells(ci, cj, ck))
        out[s : s + PLAIN_BATCH] = chunk_plane_fields(t, w, ci, cj, ck, vs, ox, oy, oz, nbx, nzc,
                                                      min_count)
    return out.reshape(planes_shape((nx, ny, nz)))


def launch_extract_kernel(data: torch.Tensor, params: torch.Tensor) -> torch.Tensor:
    """The CUDA K7 launch: a new planes tensor of ``data``'s volume (every
    element written by the kernel, so allocated without a fill)."""
    layout, dims = cuda_lib.volume_layout("planes_extract", data)
    cuda_lib.require_cuda("planes_extract", data, dtype=data.dtype)
    cuda_lib.require_cuda("planes_extract", params)
    if any(d % 8 for d in dims) or dims[2] % CHUNK_Z or params.numel() < 6:
        raise ValueError("planes_extract: bad volume or params shapes")
    if data.data_ptr() % 16:
        raise ValueError("planes_extract: the volume must be 16-byte aligned (bulk copies)")
    planes = torch.empty(planes_shape(dims), dtype=torch.float32, device=data.device)
    n_chunks = (dims[0] // 8) * (dims[1] // 8) * (dims[2] // CHUNK_Z)
    grid = stream_grid(n_chunks, *_card("planes_extract", _layout_key(layout), data.device.index))
    next_chunk = torch.empty(1, dtype=torch.int32, device=data.device)  # zeroed by the launch
    cuda_lib.launch(
        "hs_planes_extract", data.device,
        data.data_ptr(), layout, planes.data_ptr(), *dims, params.data_ptr(),
        next_chunk.data_ptr(), grid,
    )
    cuda_lib.launch_counts["planes_extract"] += 1
    return planes


def extract_subblock_planes(vol: TsdfVolume, min_count: float = 6.0) -> torch.Tensor:
    """(X/8, Y/8, Z/128, 16, 16) sub-block planes of every chunk of the
    volume, on its device: K7 on a CUDA volume, its plain version on a CPU
    one."""
    _, dims = cuda_lib.volume_layout("extract_subblock_planes", vol.data)
    if any(d % 8 for d in dims) or dims[2] % CHUNK_Z:
        raise ValueError(f"extract_subblock_planes: a volume tiling into (8, 8, 128) chunks "
                         f"required, got {dims}")
    params = _extract_params(vol, min_count, dims[0] // 8)
    if vol.data.device.type == "cpu":
        cuda_lib.plain_counts["planes_extract"] += 1
        return extract_planes_plain(vol.data, params)
    return launch_extract_kernel(vol.data, params)
