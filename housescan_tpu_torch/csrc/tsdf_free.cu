// K5: the pure-free carve of the streaming TSDF integrate (replaces
// housescan_tpu/ops/tsdf_stream.py _free_kernel, called from
// tsdf_integrate_stream with free_split=True). See
// housescan_tpu_torch/ops/tsdf_stream.py for the plain version
// (free_carve_plain) and ops/chunk_select.py for the free work list.
//
// Bound: device-memory bytes. Each member chunk's 8192 voxels are read
// once (packed and bfloat16: 32 KB; float32: 64 KB), the words the carve changes are
// written once (a word that keeps its value need not be: on the orbit
// under 1% of them change) and its (16, 16) planes tile is written (1
// KB); the arithmetic is ~30 float operations a voxel, below the bytes on
// this card.
//
// Design. A persistent grid (the wrapper's stream_grid over 16 items a
// free-list entry: at most the resident blocks an SM times the SMs) walks
// the items i = b, b + grid, ... below 16 x the device-side count, item i
// being member slot s = i % 16 = qi * 4 + qj of entry e = i / 16, i.e.
// chunk (4 bi + qi, 4 bj + qj, bk). An item on a clear member bit costs
// one bitmap read; the host never reads the count, no block is spent past
// it, and a non-member chunk is never touched (the TPU kernel copies it
// through unchanged, which on the GPU is leaving it alone).
//
// A block is 4 warps, and warp q carves z-quarter q of its item's chunk
// (the 64 (ix, iy) rows x 32 z), on its own: no block barrier. Lane l
// takes z = 32 q + 4 (l % 8) .. + 3 as one 16-byte vector and the rows
// r = l / 8 + 4 j (ix = j / 2, iy = l / 8 + 4 (j % 2)), so a warp
// instruction reads or writes 4 whole 128-byte row segments. Bytes in
// flight: a warp loads a pass of 8 such vectors (packed: 8 rows; float32:
// 4 rows of both planes) before its first store, 4 KB; at the 16-20
// resident warps an SM (chip_smoke.py's occupancy report) that is 64-80
// KB an SM, against the ~25 KB that Little's law asks for at 3.35 TB/s
// and ~1 us of latency. A vector is stored only where one of its cells
// changed (a voxel out of view keeps its word unless its weight exceeds
// the cap): the memory ends
// bit-identical to a store of every cell.
//
// Per voxel, the CLS_FREE carve of the reference verbatim: the camera
// terms of the voxel's x, y and z (common.cuh's hs_voxel_axis) added x,
// y, z, the in-view test multiplied through by zc, wnew = min(wold +
// wadd, max_weight), tnew = (told wold + wadd) / max(wold + wadd, 1) only
// where in view (elsewhere tcur = told and the division is skipped), the
// store of the volume's layout (the packed write rounds half to even;
// float32 stores as is, bfloat16 rounds to nearest even). An X-slab of a
// sharded volume takes world x from ci + params[26] (its first global X
// block); its data, planes and free list stay slab-local. Per z-quarter, min observed t, min observed w
// and max w (warp reductions: exact in any order) give the saturation
// flag; the tile is zeros with the four flags in field 11, columns 0-3,
// warp q writing the tile's entries q, q + 4, ... . Eligibility (no
// observed negative tsdf in a member chunk) means the carve creates no
// zero crossing, so this is the tile K4 writes on its no-crossing branch.
#include "common.cuh"

#define TF_THREADS 128  // 4 warps: one a z-quarter of a chunk
#define TF_TILE 256     // (N_FIELDS, NSUB_C) = (16, 16) planes tile of a chunk
#define TF_FLAG 176     // field 11, column 0 of the tile
#define TF_BIG 1.0e9f

// Four consecutive cells (z to z + 3, 16-byte aligned) of a volume store,
// as raw words: load, read cell k, replace cell k with the stored form of
// (t, w) noting whether a word changed, and write the vectors back only
// where a word changed.
template <class Store>
struct TfQuad;

template <>
struct TfQuad<HsPacked> {
  static constexpr int kPlanes = 1;
  int4 c;
  bool changed;
  __device__ __forceinline__ void load(const HsPacked& s, size_t a) {
    c = *reinterpret_cast<const int4*>(s.v + a);
    changed = false;
  }
  __device__ __forceinline__ void get(int k, float& t, float& w) const {
    const int v = (&c.x)[k];
    t = hs_unpack_t(v);
    w = hs_unpack_w(v);
  }
  __device__ __forceinline__ void set(int k, float t, float w) {
    const int v = hs_pack(t, w);
    changed |= v != (&c.x)[k];
    (&c.x)[k] = v;
  }
  __device__ __forceinline__ void store(const HsPacked& s, size_t a) const {
    if (changed) *reinterpret_cast<int4*>(s.v + a) = c;
  }
};

template <>
struct TfQuad<HsPlanar<float>> {
  static constexpr int kPlanes = 2;
  float4 t4, w4;
  bool t_changed, w_changed;
  __device__ __forceinline__ void load(const HsPlanar<float>& s, size_t a) {
    t4 = *reinterpret_cast<const float4*>(s.v + a);
    w4 = *reinterpret_cast<const float4*>(s.v + s.plane + a);
    t_changed = w_changed = false;
  }
  __device__ __forceinline__ void get(int k, float& t, float& w) const {
    t = (&t4.x)[k];
    w = (&w4.x)[k];
  }
  __device__ __forceinline__ void set(int k, float t, float w) {
    // compared as bits: a NaN kept is no change, -0 for +0 is one
    t_changed |= __float_as_int(t) != __float_as_int((&t4.x)[k]);
    w_changed |= __float_as_int(w) != __float_as_int((&w4.x)[k]);
    (&t4.x)[k] = t;
    (&w4.x)[k] = w;
  }
  __device__ __forceinline__ void store(const HsPlanar<float>& s, size_t a) const {
    if (t_changed) *reinterpret_cast<float4*>(s.v + a) = t4;
    if (w_changed) *reinterpret_cast<float4*>(s.v + s.plane + a) = w4;
  }
};

// bfloat16: four cells are 8 bytes a plane, loaded and stored as one
// 8-byte vector (a warp instruction still covers 4 row segments of 64
// bytes; the lane-to-cell map is the other layouts').
template <>
struct TfQuad<HsPlanar<__nv_bfloat16>> {
  static constexpr int kPlanes = 2;
  uint2 t2, w2;
  bool t_changed, w_changed;
  static __device__ __forceinline__ __nv_bfloat16 cell(const uint2& v, int k) {
    return reinterpret_cast<const __nv_bfloat16*>(&v)[k];
  }
  __device__ __forceinline__ void load(const HsPlanar<__nv_bfloat16>& s, size_t a) {
    t2 = *reinterpret_cast<const uint2*>(s.v + a);
    w2 = *reinterpret_cast<const uint2*>(s.v + s.plane + a);
    t_changed = w_changed = false;
  }
  __device__ __forceinline__ void get(int k, float& t, float& w) const {
    t = __bfloat162float(cell(t2, k));
    w = __bfloat162float(cell(w2, k));
  }
  __device__ __forceinline__ void set(int k, float t, float w) {
    const __nv_bfloat16 tb = __float2bfloat16_rn(t), wb = __float2bfloat16_rn(w);
    __nv_bfloat16* tc = reinterpret_cast<__nv_bfloat16*>(&t2) + k;
    __nv_bfloat16* wc = reinterpret_cast<__nv_bfloat16*>(&w2) + k;
    t_changed |= __bfloat16_as_ushort(tb) != __bfloat16_as_ushort(*tc);
    w_changed |= __bfloat16_as_ushort(wb) != __bfloat16_as_ushort(*wc);
    *tc = tb;
    *wc = wb;
  }
  __device__ __forceinline__ void store(const HsPlanar<__nv_bfloat16>& s, size_t a) const {
    if (t_changed) *reinterpret_cast<uint2*>(s.v + a) = t2;
    if (w_changed) *reinterpret_cast<uint2*>(s.v + s.plane + a) = w2;
  }
};

template <class Store>
__global__ void __launch_bounds__(TF_THREADS)
tsdf_free_kernel(Store vol, float* __restrict__ planes,
                 const int* __restrict__ bitmap, const int* __restrict__ count,
                 const int* __restrict__ bi, const int* __restrict__ bj,
                 const int* __restrict__ bk, int ny, int nz, const float* __restrict__ p,
                 float sat_w) {
  using Quad = TfQuad<Store>;
  constexpr int kRows = 8 / Quad::kPlanes;  // rows a pass: 8 vector loads a lane
  const int n_items = *count * 16;
  const int lane = threadIdx.x & 31, q = threadIdx.x >> 5;
  const int zq = q * 32 + (lane & 7) * 4;  // the lane's first z in the chunk
  const int rsub = lane >> 3;
  // the in-view test's constants, as hs_in_view_free forms them
  const float fx = p[12], fy = p[13], ncx = -p[14], ncy = -p[15];
  const float kx = p[22] - 1.0f - p[14], ky = p[23] - 1.0f - p[15];
  const float max_weight = p[21];
  const int bx0 = (int)p[26];  // a slab's first global X block: world x only

  for (int i = blockIdx.x; i < n_items; i += gridDim.x) {
    const int e = i >> 4, slot = i & 15;
    if (((bitmap[e] >> slot) & 1) == 0) continue;
    const int ci = bi[e] * 4 + (slot >> 2), cj = bj[e] * 4 + (slot & 3), ck = bk[e];

    HsAxisTerms az[4], ay[2];
#pragma unroll
    for (int k = 0; k < 4; ++k) az[k] = hs_voxel_axis(p, 2, ck * 128, zq + k);
#pragma unroll
    for (int h = 0; h < 2; ++h) ay[h] = hs_voxel_axis(p, 1, cj * 8, rsub + 4 * h);
    const size_t base = ((size_t)(ci * 8) * ny + cj * 8) * nz + (size_t)ck * 128 + zq;

    float mn_t = 1.0f, mn_w = TF_BIG, mx_w = -1.0f;
#pragma unroll 1  // one pass's registers at a time: more resident warps
    for (int j0 = 0; j0 < 16; j0 += kRows) {
      Quad cells[kRows];
#pragma unroll
      for (int jj = 0; jj < kRows; ++jj) {
        const int j = j0 + jj, ix = j >> 1, iy = rsub + 4 * (j & 1);
        cells[jj].load(vol, base + ((size_t)ix * ny + iy) * nz);
      }
#pragma unroll
      for (int jj = 0; jj < kRows; ++jj) {
        const int j = j0 + jj;
        const HsAxisTerms ax = hs_voxel_axis(p, 0, (ci + bx0) * 8, j >> 1);
        const HsAxisTerms& y = ay[j & 1];
        const float sx = ax.c0 + y.c0, sy = ax.c1 + y.c1, sz = ax.c2 + y.c2;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const float xc = sx + az[k].c0, yc = sy + az[k].c1, zc = sz + az[k].c2;
          const float fxx = fx * xc, fyy = fy * yc;
          const bool iv = (zc > 1e-6f) && (fxx >= ncx * zc) && (fxx <= kx * zc) &&
                          (fyy >= ncy * zc) && (fyy <= ky * zc);
          float told, wold;
          cells[jj].get(k, told, wold);
          const float wadd = iv ? 1.0f : 0.0f;
          const float wnew = fminf(wold + wadd, max_weight);
          float tcur = told;
          if (iv) tcur = (told * wold + wadd) / hs_clamp_min(wold + wadd, 1.0f);
          cells[jj].set(k, tcur, wnew);
          const bool obs = wnew > 0.0f;
          mn_t = fminf(mn_t, obs ? tcur : 1.0f);
          mn_w = fminf(mn_w, obs ? wnew : TF_BIG);
          mx_w = fmaxf(mx_w, wnew);
        }
      }
#pragma unroll
      for (int jj = 0; jj < kRows; ++jj) {
        const int j = j0 + jj, ix = j >> 1, iy = rsub + 4 * (j & 1);
        cells[jj].store(vol, base + ((size_t)ix * ny + iy) * nz);
      }
    }

    mn_t = hs_warp_min(mn_t);
    mn_w = hs_warp_min(mn_w);
    mx_w = hs_warp_max(mx_w);
    const float flag = (mn_w >= sat_w && mn_t > 0.999f && mx_w > 0.0f) ? 1.0f : 0.0f;
    float* tile = planes + (((size_t)ci * (ny / 8) + cj) * (nz / 128) + ck) * TF_TILE;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int o = q + 4 * (lane + 32 * h);
      tile[o] = o == TF_FLAG + q ? flag : 0.0f;
    }
  }
}

template <class Store>
static int tf_launch(Store vol, float* planes, const int* bitmap, const int* count, const int* bi,
                     const int* bj, const int* bk, int grid, int ny, int nz, const float* params,
                     float sat_w, cudaStream_t stream) {
  tsdf_free_kernel<Store><<<grid, TF_THREADS, 0, stream>>>(vol, planes, bitmap, count, bi, bj,
                                                           bk, ny, nz, params, sat_w);
  return (int)cudaGetLastError();
}

// layout: HS_LAYOUT_PACKED (vol is the (nx, ny, nz) int32 grid),
// HS_LAYOUT_F32 or HS_LAYOUT_BF16 (vol is the (2, nx, ny, nz) float32 or
// bfloat16 array); grid: the persistent grid (ops/tsdf_stream.stream_grid
// over 16 items an entry).
extern "C" int hs_tsdf_free(void* vol, int layout, float* planes, const int* bitmap,
                            const int* count, const int* bi, const int* bj, const int* bk,
                            int grid, int nx, int ny, int nz, const float* params, float sat_w,
                            void* stream) {
  if (grid <= 0) return 0;
  const cudaStream_t st = (cudaStream_t)stream;
  if (layout == HS_LAYOUT_PACKED)
    return tf_launch(HsPacked{(int*)vol}, planes, bitmap, count, bi, bj, bk, grid, ny, nz, params,
                     sat_w, st);
  if (layout == HS_LAYOUT_F32)
    return tf_launch(HsPlanar<float>{(float*)vol, (size_t)nx * ny * nz}, planes, bitmap, count,
                     bi, bj, bk, grid, ny, nz, params, sat_w, st);
  if (layout == HS_LAYOUT_BF16)
    return tf_launch(HsPlanar<__nv_bfloat16>{(__nv_bfloat16*)vol, (size_t)nx * ny * nz}, planes,
                     bitmap, count, bi, bj, bk, grid, ny, nz, params, sat_w, st);
  return (int)cudaErrorInvalidValue;
}

// Resident blocks an SM: out[0] packed, out[1] float32, out[2] bfloat16.
extern "C" int hs_tsdf_free_occupancy(int, int* out) {
  int e = hs_occupancy(tsdf_free_kernel<HsPacked>, TF_THREADS, 0, out);
  if (!e) e = hs_occupancy(tsdf_free_kernel<HsPlanar<float>>, TF_THREADS, 0, out + 1);
  return e ? e : hs_occupancy(tsdf_free_kernel<HsPlanar<__nv_bfloat16>>, TF_THREADS, 0, out + 2);
}
