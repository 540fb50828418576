// K7: the whole-volume sub-block plane extraction (replaces
// housescan_tpu/ops/planes_pallas.py _kernel, line 372, called at :405 by
// extract_subblock_planes). See housescan_tpu_torch/ops/planes_cuda.py for
// the plain version.
//
// Bound: device-memory bytes. The function needs every weight (4 bytes a
// voxel; bfloat16 2), the tsdf of the observed voxels only (an unobserved voxel reads
// no neighbour and adds no term, and as a neighbour its weight 0 rules the
// crossing out) and the (16, 16) planes tile of each chunk written; a
// packed cell holds both values in its 4 bytes. The fit is ~30 float
// operations an observed voxel, a few percent of the volume: far below.
//
// Design: weights first, in ONE launch. A persistent grid of 256-thread
// blocks, two an SM, claims chunks from a counter (block b starts on
// chunks b, b + G, ... for its first ring's worth; an observed chunk costs
// more than the others, so a block that meets them claims fewer). Each
// block streams its chunks' weight planes (packed: the cells) through a
// ring of shared-memory buffers (float32: 2 and a tsdf plane; packed: 3),
// 64 bulk copies of a 512-byte z-row a chunk on an mbarrier a buffer, all
// but one buffer in flight ahead of the chunk being read; while one block
// waits on an observed chunk's tsdf and fits it, the SM's other block
// keeps its copies streaming. For each chunk:
//   1. warp w tests sub-blocks w and w + 8 with 16-byte loads, a bit for
//      each (x, y) row's 8-voxel z-segment that holds an observed voxel;
//      one barrier ORs the warps' answers;
//   2. a chunk with no observed voxel (most of them) frees its buffer at
//      once (the next claimed chunk's copies go in) and writes its tile
//      from the shape of all-zero moments, computed once a block;
//   3. else (float32) each observed sub-block's warp reads the tsdf of its
//      observed z-segments only (32-byte sectors) into a tsdf plane in
//      shared memory; after a barrier it fits its sub-block from the
//      staged copies (planes.cuh, as K4 and K8; the +z neighbour of a
//      segment's last voxel lies in the next sub-block, fetched there
//      wherever it is observed) if any voxel the fit reads is observed
//      with a tsdf below 0.99, which every term needs (observed free
//      space, tsdf 1, has none: its moments are zero without a pass); a
//      packed chunk tests and fits from its staged cells;
//   4. after a barrier the buffer is restaged, and 16 lanes of one warp
//      (a different warp each chunk, so the others go on) emit the 16
//      sub-blocks' fields side by side and store the tile coalesced; an
//      unobserved sub-block takes the all-zero shape, so only observed
//      ones run the eigen analysis.
// Every field of every chunk is written (field 11 zero), so the wrapper
// allocates the planes without a fill. Same float32 operations in the
// same order as the plain version (--fmad=false), the moments summed in
// planes.cuh's double order: bit-identical. CUDA C++ rather than Triton:
// bulk copies completing on mbarriers through a per-block ring, and the
// fit is planes.cuh's, shared with K4 and K8.
#include "planes.cuh"

#define PE_THREADS 256
#define PE_WARPS (PE_THREADS / 32)
#define PE_SUBS (HS_NSUB / PE_WARPS)  // sub-blocks a warp tests, fetches and fits
#define PE_BLOCKS_SM 2                // resident blocks an SM, by registers and the ring
#define PE_ROW HS_STAGE_ROW           // cells a staged z-row (128 and padding)
#define PE_PLANE (64 * PE_ROW)        // a staged plane, in cells
#define PE_TILE (HS_N_FIELDS * HS_NSUB)

// The ring's buffers (one a chunk) and the dynamic shared memory, in the
// store's cells: the (2, X, Y, Z) layouts keep one more plane for the
// tsdf of the chunk being fitted; a block takes at most half the SM's
// shared memory. kRowBytes: a z-row's bulk copy (512 bytes; bfloat16 256,
// its staged row 272, both multiples of 16).
template <class Store>
struct PeRing {
  using Cell = typename Store::Cell;
  static constexpr int kBufs = Store::kPlanes == 2 ? 2 : 3;
  static constexpr int kRowBytes = 128 * (int)sizeof(Cell);
  static constexpr int kSmem =
      (kBufs + (Store::kPlanes == 2 ? 1 : 0)) * PE_PLANE * (int)sizeof(Cell);
};

// Whether any of the 4 staged cells from ``o`` is observed (weight > 0):
// the (2, X, Y, Z) layouts stage the weight plane, packed the cells.
template <class Store>
__device__ __forceinline__ bool pe_observed4(const typename Store::Cell* buf, int o) {
  if constexpr (Store::kPlanes == 2 && sizeof(typename Store::Cell) == 2) {
    const uint2 v = *reinterpret_cast<const uint2*>(buf + o);
    const __nv_bfloat16* w = reinterpret_cast<const __nv_bfloat16*>(&v);
    return __bfloat162float(w[0]) > 0.0f || __bfloat162float(w[1]) > 0.0f ||
           __bfloat162float(w[2]) > 0.0f || __bfloat162float(w[3]) > 0.0f;
  } else if constexpr (Store::kPlanes == 2) {
    const float4 w = *reinterpret_cast<const float4*>(buf + o);
    return w.x > 0.0f || w.y > 0.0f || w.z > 0.0f || w.w > 0.0f;
  } else {
    const int4 c = *reinterpret_cast<const int4*>(buf + o);
    return hs_unpack_w(c.x) > 0.0f || hs_unpack_w(c.y) > 0.0f || hs_unpack_w(c.z) > 0.0f ||
           hs_unpack_w(c.w) > 0.0f;
  }
}

// Whether sub-block s of the staged chunk can have a moment term
// (warp-uniform): every term needs an observed voxel with a tsdf below
// 0.99 among the voxels the fit of s reads, the sub-block and the next
// one's first slice (a band voxel, or the negative side of a crossing).
// Without one its moments are all zero: exact to skip.
template <class Tw>
__device__ __forceinline__ bool pe_has_terms(const Tw& tw, int s, int lane) {
  bool any = false;
  const int zv = s * 8 + (lane & 7);
  for (int ix = 0; ix < 8; ++ix)
    for (int iy = lane >> 3; iy < 8; iy += 4) {
      float t, w;
      tw(ix, iy, zv, t, w);
      any = any || (w > 0.0f && t < 0.99f);
    }
  if (s < HS_NSUB - 1) {
    for (int xy = lane; xy < 64; xy += 32) {
      float t, w;
      tw(xy >> 3, xy & 7, s * 8 + 8, t, w);
      any = any || (w > 0.0f && t < 0.99f);
    }
  }
  return __any_sync(HS_FULL_MASK, any);
}

// The cell of row r (ix * 8 + iy), z 0 of chunk ``chunk``.
__device__ __forceinline__ size_t pe_row_cell(int chunk, int r, int nby, int nzc, int ny,
                                              int nz) {
  const int ci = chunk / (nby * nzc), cj = (chunk / nzc) % nby, ck = chunk % nzc;
  return ((size_t)(ci * 8 + (r >> 3)) * ny + (cj * 8 + (r & 7))) * nz + (size_t)ck * 128;
}

// The whole block: stage chunk ``chunk``'s weight plane (packed: its cells)
// into ``dst``, one bulk copy a z-row, 64 / PE_WARPS rows a warp; thread 0
// arrives expecting the plane's bytes.
template <class Store>
__device__ __forceinline__ void pe_stage(const Store& vol, int chunk, int nby, int nzc, int ny,
                                         int nz, typename Store::Cell* dst, uint64_t* bar,
                                         int tid) {
  constexpr int kRowBytes = PeRing<Store>::kRowBytes;
  if (tid == 0) hs_mbar_expect_tx(bar, 64 * kRowBytes);
  const int lane = tid & 31;
  if (lane < 64 / PE_WARPS) {
    const int r = (tid >> 5) * (64 / PE_WARPS) + lane;
    hs_fence_proxy_async();
    hs_bulk_load(dst + r * PE_ROW,
                 vol.plane_ptr(pe_row_cell(chunk, r, nby, nzc, ny, nz), Store::kPlanes - 1),
                 kRowBytes, bar);
  }
}

// p: voxel size, origin x, y, z, min_count, nbx (the sub-block ids' x
// stride in chunks). next_chunk: the claim counter, zeroed before the
// launch.
template <class Store>
__global__ void __launch_bounds__(PE_THREADS, PE_BLOCKS_SM)
planes_extract_kernel(Store vol, float* __restrict__ planes, int ny, int nz, int n_chunks,
                      const float* __restrict__ params, int* __restrict__ next_chunk) {
  using Cell = typename Store::Cell;
  constexpr int NB = PeRing<Store>::kBufs;
  extern __shared__ __align__(128) unsigned char s_raw[];  // NB staged planes (+ the tsdf plane)
  Cell* const s_buf = reinterpret_cast<Cell*>(s_raw);
  __shared__ __align__(8) uint64_t s_bar[NB];
  __shared__ int s_item[NB];  // the chunk in each buffer (n_chunks or more: none)
  __shared__ int s_next[2];   // the chunk item t's release stages, at t & 1
  __shared__ float s_mom[HS_NSUB][HS_NMOM + 1];
  __shared__ float s_zero[HS_NMOM];  // all-zero moments
  __shared__ HsPlaneShape s_empty;   // their shape (an unobserved sub-block's)
  __shared__ float p[6];

  const int nby = ny / 8, nzc = nz / 128;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int grid = gridDim.x;
  Cell* s_t = s_buf + NB * PE_PLANE;  // (2, X, Y, Z): the tsdf of the observed z-segments
  // thread 0: the claim that item t + 1's release will stage, taken one
  // item early so that the counter's latency is hidden
  int pending = 0;
  if (tid == 0) {
    for (int b = 0; b < NB; ++b) {
      hs_mbar_init(&s_bar[b], 1);
      s_item[b] = blockIdx.x + b * grid;
    }
    s_next[0] = NB * grid + atomicAdd(next_chunk, 1);
    pending = NB * grid + atomicAdd(next_chunk, 1);
  }
  if (tid < HS_NMOM) s_zero[tid] = 0.0f;
  if (tid < 6) p[tid] = params[tid];
  __syncthreads();
  if (tid == 0) s_empty = hs_plane_shape(s_zero);
  for (int b = 0; b < NB; ++b)
    if (s_item[b] < n_chunks)
      pe_stage(vol, s_item[b], nby, nzc, ny, nz, s_buf + b * PE_PLANE, &s_bar[b], tid);

  for (int t = 0;; ++t) {
    const int b = t % NB;
    const int chunk = s_item[b];
    if (chunk >= n_chunks) break;
    if (tid == 0 && t > 0) {
      s_next[t & 1] = pending;
      pending = NB * grid + atomicAdd(next_chunk, 1);
    }
    const Cell* buf = s_buf + b * PE_PLANE;
    hs_mbar_wait(&s_bar[b], (t / NB) & 1);

    // 1. warp w tests sub-blocks w + PE_WARPS q; lane l reads rows (l >> 1)
    // + 16 k, half l & 1 of a sub-block's z-segment; bit 4 q + k: that
    // row's segment holds an observed voxel
    unsigned seg = 0;
    bool observed[PE_SUBS], any_observed = false;
#pragma unroll
    for (int q = 0; q < PE_SUBS; ++q) {
      const int sb = warp + PE_WARPS * q;
      unsigned bits = 0;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int o = ((lane >> 1) + 16 * k) * PE_ROW + 8 * sb + 4 * (lane & 1);
        int any = pe_observed4<Store>(buf, o) ? 1 : 0;
        any |= __shfl_xor_sync(HS_FULL_MASK, any, 1);
        bits |= (unsigned)any << k;
      }
      seg |= bits << (4 * q);
      observed[q] = __any_sync(HS_FULL_MASK, bits != 0u);
      any_observed = any_observed || observed[q];
    }
    const bool fit = __syncthreads_or(any_observed);

    if (fit) {
      // 3. the tsdf of the observed segments (float32), then the fits
      if constexpr (Store::kPlanes == 2) {
#pragma unroll
        for (int q = 0; q < PE_SUBS; ++q)
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            if (!((seg >> (4 * q + k)) & 1u)) continue;
            const int r = (lane >> 1) + 16 * k, z = 8 * (warp + PE_WARPS * q) + 4 * (lane & 1);
            const Cell* src = vol.v + pe_row_cell(chunk, r, nby, nzc, ny, nz) + z;
            if constexpr (sizeof(Cell) == 2) {  // bfloat16: 4 cells, 8 bytes
              *reinterpret_cast<uint2*>(s_t + r * PE_ROW + z) =
                  __ldg(reinterpret_cast<const uint2*>(src));
            } else {
              *reinterpret_cast<float4*>(s_t + r * PE_ROW + z) =
                  __ldg(reinterpret_cast<const float4*>(src));
            }
          }
        __syncthreads();
      }
#pragma unroll
      for (int q = 0; q < PE_SUBS; ++q) {
        const int sb = warp + PE_WARPS * q;
        bool terms = false;
        if (observed[q]) {
          double acc[HS_NMOM];
          if constexpr (Store::kPlanes == 2) {
            const HsSmemChunk<Cell> tw{s_t, buf, PE_ROW};
            terms = pe_has_terms(tw, sb, lane);
            if (terms) hs_subblock_moments_warp(tw, sb, lane, 127, acc);
          } else {
            const HsStagedChunk<Store> tw{buf};
            terms = pe_has_terms(tw, sb, lane);
            if (terms) hs_subblock_moments_warp(tw, sb, lane, 127, acc);
          }
          if (terms && lane == 0)
            for (int k = 0; k < HS_NMOM; ++k) s_mom[sb][k] = (float)acc[k];
        }
        if (!terms && lane == 0) s_mom[sb][10] = s_mom[sb][11] = 0.0f;
      }
      __syncthreads();  // the moments in s_mom; buffer b and the tsdf plane free
    }

    // 2. / 4. buffer b is free: stage the chunk claimed for item t + NB
    const int c2 = s_next[t & 1];
    if (tid == 0) s_item[b] = c2;
    if (c2 < n_chunks) pe_stage(vol, c2, nby, nzc, ny, nz, s_buf + b * PE_PLANE, &s_bar[b], tid);

    // the tile: 16 lanes of warp t % PE_WARPS, sub-block = lane, stored
    // coalesced
    // (s_mom is next written after item t + 1's first barrier, which this
    // warp reaches only when done here)
    if (warp == t % PE_WARPS && lane < HS_NSUB) {
      const int ci = chunk / (nby * nzc), cj = (chunk / nzc) % nby, ck = chunk % nzc;
      HsFitGeom g;
      g.ci = ci;
      g.cj = cj;
      g.z_base = (float)(ck * 128);
      g.sid_base = (((long long)ci * (int)p[5] + cj) * nzc + ck) * HS_NSUB;
      g.vs = p[0];
      g.ox = p[1];
      g.oy = p[2];
      g.oz = p[3];
      g.min_count = p[4];
      const float* m = s_mom[lane];
      float f[HS_N_FIELDS];
      hs_plane_emit(!fit || (m[10] == 0.0f && m[11] == 0.0f) ? s_empty : hs_plane_shape(m), g,
                    (float)lane, f);
      float* dst = planes + (size_t)chunk * PE_TILE + lane;
#pragma unroll
      for (int k = 0; k < HS_N_FIELDS; ++k) dst[k * HS_NSUB] = f[k];
    }
  }
}

template <class Store>
static int pe_launch(Store vol, float* planes, int n_chunks, int ny, int nz, const float* params,
                     int* next_chunk, int grid, cudaStream_t stream) {
  constexpr int smem = PeRing<Store>::kSmem;
  cudaError_t e = cudaFuncSetAttribute(planes_extract_kernel<Store>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  e = cudaMemsetAsync(next_chunk, 0, sizeof(int), stream);
  if (e != cudaSuccess) return (int)e;
  planes_extract_kernel<Store><<<grid, PE_THREADS, smem, stream>>>(vol, planes, ny, nz, n_chunks,
                                                                  params, next_chunk);
  return (int)cudaGetLastError();
}

// layout: HS_LAYOUT_PACKED (vol is the (nx, ny, nz) int32 grid),
// HS_LAYOUT_F32 or HS_LAYOUT_BF16 (vol is the (2, nx, ny, nz) float32 or
// bfloat16 array); planes is the
// (nx / 8, ny / 8, nz / 128, 16, 16) output, every element written;
// next_chunk: one int of scratch (the claim counter, zeroed here); grid:
// the persistent grid (at most the resident blocks an SM times the SMs).
extern "C" int hs_planes_extract(void* vol, int layout, float* planes, int nx, int ny, int nz,
                                 const float* params, int* next_chunk, int grid, void* stream) {
  if (nx % 8 || ny % 8 || nz % 128) return (int)cudaErrorInvalidValue;
  const int n_chunks = (nx / 8) * (ny / 8) * (nz / 128);
  if (n_chunks <= 0 || grid <= 0) return 0;
  const cudaStream_t st = (cudaStream_t)stream;
  if (layout == HS_LAYOUT_PACKED)
    return pe_launch(HsPacked{(int*)vol}, planes, n_chunks, ny, nz, params, next_chunk, grid, st);
  if (layout == HS_LAYOUT_F32)
    return pe_launch(HsPlanar<float>{(float*)vol, (size_t)nx * ny * nz}, planes, n_chunks, ny, nz,
                     params, next_chunk, grid, st);
  if (layout == HS_LAYOUT_BF16)
    return pe_launch(HsPlanar<__nv_bfloat16>{(__nv_bfloat16*)vol, (size_t)nx * ny * nz}, planes,
                     n_chunks, ny, nz, params, next_chunk, grid, st);
  return (int)cudaErrorInvalidValue;
}

// Resident blocks an SM: out[0] packed, out[1] float32, out[2] bfloat16.
extern "C" int hs_planes_extract_occupancy(int, int* out) {
  int e = hs_occupancy(planes_extract_kernel<HsPacked>, PE_THREADS, PeRing<HsPacked>::kSmem, out);
  if (!e)
    e = hs_occupancy(planes_extract_kernel<HsPlanar<float>>, PE_THREADS,
                     PeRing<HsPlanar<float>>::kSmem, out + 1);
  return e ? e : hs_occupancy(planes_extract_kernel<HsPlanar<__nv_bfloat16>>, PE_THREADS,
                              PeRing<HsPlanar<__nv_bfloat16>>::kSmem, out + 2);
}
