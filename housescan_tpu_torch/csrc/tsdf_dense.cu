// K8: the first-generation dense TSDF integrate over (8, 8, R) columns with
// the fused column plane fit (replaces housescan_tpu/ops/tsdf_pallas.py
// _kernel, line 53, called at :443 by tsdf_integrate_with_planes). See
// housescan_tpu_torch/ops/tsdf_cuda.py for the plain version and the
// design note.
//
// Two launches, on the float32 (2, X, Y, Z) volume in place:
//
// tsdf_dense_kernel, one block of 512 threads per (8, 8, 128) chunk
// (thread t owns z = t % 128 and the voxels ix * 8 + iy = t / 128 + 4 k):
//   1. the chunk's exact in-view bbox (u, v, camera z) over its 8192 voxel
//      centres, plain in_view test;
//   2. the L3 rectangle: 24 rows of the (64, 128) 8x8-block min, max and
//      all-valid maps of the depth, from the row of the bbox's top, gives
//      dmin, dmax and all_valid over the footprint;
//   3. SKIP (nothing in view, or behind: zmin - trunc > dmax), FREE
//      (bbox <= 120 px, zmax + trunc < dmin, dmax > 0, every footprint
//      pixel valid: depth = BIG, so the sample is +1) or BAND (the mip
//      level whose 32 x 256 window the bbox fits, at v0 & ~7, u0 & ~127);
//   4. BAND: hat-weight bilinear depth over the window, contracted over
//      rows then columns and renormalised by the valid-pixel weight; then
//      the weighted running mean and the weight cap. A SKIP chunk is not
//      read or written at all (the reference copies it through).
// Its class goes to cls (0 SKIP, 1 FREE, 2 BAND), for the bound and the
// comparison with the plain version.
//
// tsdf_dense_fit_kernel, one block per chunk after the integrate: the
// chunk and the first z-slice of the next (the halo: the column fit counts
// the z-crossings between the column's chunks; only z = R - 1 is masked)
// go to shared memory, and warp s fits sub-block s with the device fit of
// planes.cuh, under the column's ids (sub-block (i nbx + j) R / 8 + s,
// s < R / 8) and written to lanes [16 ck, 16 ck + 16) of the column's
// (16, 128) planes tile. The fit needs the integrate's result in the next
// chunk, hence the second launch.
//
// Bound: device-memory bytes. The fit must read every voxel once (8 bytes,
// float32), the integrate write every visited chunk once, plus the mips
// and the planes; ~60 float operations a voxel.
#include "planes.cuh"

#define TD_THREADS 512
#define TD_BIG 1.0e9f
#define TD_L3_V 64    // rows of the L3 min / max / valid maps
#define TD_L3_U 128   // their columns
#define TD_RECT_V 24  // rows of the footprint rectangle
#define TD_WIN_V 32
#define TD_WIN_U 256
#define TD_ZS 129  // z-stride of a chunk with its halo slice in shared memory

enum { TD_SKIP = 0, TD_FREE = 1, TD_BAND = 2 };

struct TdMips {
  const float* m[4];  // L0, L1, L2 padded, then the (64, 256) L3 window
  int h[4];
  int w[4];
  const float* l3min;    // (64, 128): min valid depth of each 8x8 block (BIG if none)
  const float* l3max;    // (64, 128): max depth of each block
  const float* l3valid;  // (64, 128): 1 where every pixel of the block is valid
};

__device__ __forceinline__ float td_block_min(float v, float* red, int lane, int warp) {
  v = hs_warp_min(v);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float r = red[0];
  for (int w8 = 1; w8 < TD_THREADS / 32; ++w8) r = fminf(r, red[w8]);
  __syncthreads();
  return r;
}

__device__ __forceinline__ float td_block_max(float v, float* red, int lane, int warp) {
  v = hs_warp_max(v);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float r = red[0];
  for (int w8 = 1; w8 < TD_THREADS / 32; ++w8) r = fmaxf(r, red[w8]);
  __syncthreads();
  return r;
}

template <class Store>
__global__ void __launch_bounds__(TD_THREADS)
tsdf_dense_kernel(Store vol, int ny, int nz, TdMips mips, const float* __restrict__ p,
                  int* __restrict__ cls) {
  __shared__ float s_red[TD_THREADS / 32];
  const int nby = ny / 8, nzc = nz / 128;
  const int chunk = blockIdx.x;
  const int ci = chunk / (nby * nzc), cj = (chunk / nzc) % nby, ck = chunk % nzc;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int z = tid & 127;
  const float trunc = p[16], max_weight = p[21];

  // 1. the in-view bbox (min / max: exact in any order)
  float umin = TD_BIG, umax = -TD_BIG, vmin = TD_BIG, vmax = -TD_BIG, zmin = TD_BIG,
        zmax = -TD_BIG;
  bool anyv = false;
  for (int k = 0; k < 16; ++k) {
    const int xy = (tid >> 7) + 4 * k;
    HsVoxel c;
    hs_voxel_coords(p, ci, cj, ck, xy >> 3, xy & 7, z, c);
    if (c.iv > 0.5f) {
      umin = fminf(umin, c.uf);
      umax = fmaxf(umax, c.uf);
      vmin = fminf(vmin, c.vf);
      vmax = fmaxf(vmax, c.vf);
      zmin = fminf(zmin, c.zc);
      zmax = fmaxf(zmax, c.zc);
      anyv = true;
    }
  }
  if (!__syncthreads_or(anyv)) {
    if (tid == 0) cls[chunk] = TD_SKIP;
    return;
  }
  umin = td_block_min(umin, s_red, lane, warp);
  umax = td_block_max(umax, s_red, lane, warp);
  vmin = td_block_min(vmin, s_red, lane, warp);
  vmax = td_block_max(vmax, s_red, lane, warp);
  zmin = td_block_min(zmin, s_red, lane, warp);
  zmax = td_block_max(zmax, s_red, lane, warp);

  // 2. the L3 rectangle over the footprint
  const int r0 = min(max((int)(vmin / 8.0f) - 1, 0), TD_L3_V - TD_RECT_V) & ~7;
  float dmin = TD_BIG, dmax = -TD_BIG;
  bool allv = true;
  for (int i = tid; i < TD_RECT_V * TD_L3_U; i += TD_THREADS) {
    const int r = i / TD_L3_U, col = i % TD_L3_U;
    const float rowf = (float)r + (float)r0, colf = (float)col;
    const bool in_rect = (colf >= umin / 8.0f - 1.0f) && (colf <= umax / 8.0f + 1.0f) &&
                         (rowf >= vmin / 8.0f - 1.0f) && (rowf <= vmax / 8.0f + 1.0f);
    if (in_rect) {
      const int a = (r0 + r) * TD_L3_U + col;
      dmin = fminf(dmin, mips.l3min[a]);
      dmax = fmaxf(dmax, mips.l3max[a]);
      allv = allv && mips.l3valid[a] > 0.5f;
    }
  }
  const bool all_valid = __syncthreads_and(allv) != 0;
  dmin = td_block_min(dmin, s_red, lane, warp);
  dmax = td_block_max(dmax, s_red, lane, warp);

  // 3. classify (every thread holds the same values)
  const bool bbox_fits = (umax - umin) <= 120.0f && (vmax - vmin) <= 120.0f;
  const bool behind = bbox_fits && (zmin - trunc > dmax);
  const bool is_free = bbox_fits && (zmax + trunc < dmin) && (dmax > 0.0f) && all_valid;
  const int cl = is_free ? TD_FREE : (behind ? TD_SKIP : TD_BAND);
  if (tid == 0) cls[chunk] = cl;
  if (cl == TD_SKIP) return;

  int lvl = 3;
  const float span_u = umax - umin, span_v = vmax - vmin;
  for (int l = 2; l >= 0; --l) {
    const float s = (float)(1 << l);
    if (span_v <= 22.0f * s && span_u <= 60.0f * s) lvl = l;
  }
  const float scale = (float)(1 << lvl);
  int v0 = 0, u0 = 0;
  if (lvl < 3) {
    v0 = min(max(((int)(vmin / scale) - 1) & ~7, 0), mips.h[lvl] - TD_WIN_V);
    u0 = min(max(((int)(umin / scale) - 1) & ~127, 0), mips.w[lvl] - TD_WIN_U);
  }
  const float* mip = mips.m[lvl];
  const int mw = mips.w[lvl];
  const int nrows = lvl < 3 ? TD_WIN_V : mips.h[3];
  const float v0f = (float)v0, u0f = (float)u0;

  // 4. read-modify-write
  for (int k = 0; k < 16; ++k) {
    const int xy = (tid >> 7) + 4 * k;
    const int ix = xy >> 3, iy = xy & 7;
    const size_t addr = ((size_t)(ci * 8 + ix) * ny + (cj * 8 + iy)) * nz + (size_t)ck * 128 + z;
    HsVoxel c;
    hs_voxel_coords(p, ci, cj, ck, ix, iy, z, c);
    float d = TD_BIG;
    bool has = true;
    if (cl == TD_BAND) {
      const float uw = c.uf / scale - u0f;
      const float vw = c.vf / scale - v0f;
      const bool supp = (uw >= 0.0f) && (uw <= (float)(TD_WIN_U - 1)) && (vw >= 0.0f) &&
                        (vw <= (float)(nrows - 1));
      float den = 0.0f;
      d = 0.0f;
      if (supp) {
        const float c0f = floorf(uw), r0f = floorf(vw);
        const float wc0 = hs_clamp_min(1.0f - fabsf(uw - c0f), 0.0f);
        const float wc1 = hs_clamp_min(1.0f - fabsf(uw - (c0f + 1.0f)), 0.0f);
        const float wr0 = hs_clamp_min(1.0f - fabsf(vw - r0f), 0.0f);
        const float wr1 = hs_clamp_min(1.0f - fabsf(vw - (r0f + 1.0f)), 0.0f);
        // a tap past the window's edge has weight 0: read its neighbour
        const int c0 = (int)c0f, r0w = (int)r0f;
        const int c1 = min(c0 + 1, TD_WIN_U - 1), r1w = min(r0w + 1, nrows - 1);
        const float* row0 = mip + (size_t)(v0 + r0w) * mw + u0;
        const float* row1 = mip + (size_t)(v0 + r1w) * mw + u0;
        const float p00 = __ldg(row0 + c0), p01 = __ldg(row0 + c1);
        const float p10 = __ldg(row1 + c0), p11 = __ldg(row1 + c1);
        const float q00 = p00 > 0.0f ? 1.0f : 0.0f, q01 = p01 > 0.0f ? 1.0f : 0.0f;
        const float q10 = p10 > 0.0f ? 1.0f : 0.0f, q11 = p11 > 0.0f ? 1.0f : 0.0f;
        // rows first (window^T @ row weights), then columns
        const float num = (p00 * wr0 + p10 * wr1) * wc0 + (p01 * wr0 + p11 * wr1) * wc1;
        den = (q00 * wr0 + q10 * wr1) * wc0 + (q01 * wr0 + q11 * wr1) * wc1;
        d = num / hs_clamp_min(den, 1e-12f);
      }
      has = supp && den > 1e-6f;
    }
    float told, wold;
    vol.load(addr, told, wold);
    const float sdf = d - c.zc;
    const bool update = (c.iv > 0.5f) && has && (sdf >= -trunc);
    const float sample = hs_clamp_max(hs_clamp_min(sdf / trunc, -1.0f), 1.0f);
    const float wadd = update ? 1.0f : 0.0f;
    const float wnew = fminf(wold + wadd, max_weight);
    const float denom = hs_clamp_min(wold + wadd, 1.0f);
    const float tnew = (told * wold + sample * wadd) / denom;
    vol.store(addr, update ? tnew : told, wnew);
  }
}

template <class Store>
__global__ void __launch_bounds__(TD_THREADS)
tsdf_dense_fit_kernel(Store vol, float* __restrict__ planes, int ny, int nz,
                      const float* __restrict__ p) {
  extern __shared__ float s_tw[];  // tsdf then weight, each 64 x TD_ZS
  float* s_t = s_tw;
  float* s_w = s_tw + 64 * TD_ZS;
  __shared__ float s_fields[HS_N_FIELDS][HS_NSUB];
  const int nby = ny / 8, nzc = nz / 128;
  const int chunk = blockIdx.x;
  const int ci = chunk / (nby * nzc), cj = (chunk / nzc) % nby, ck = chunk % nzc;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int z = tid & 127;
  const bool halo = ck + 1 < nzc;

  for (int k = 0; k < 16; ++k) {
    const int xy = (tid >> 7) + 4 * k;
    const size_t addr =
        ((size_t)(ci * 8 + (xy >> 3)) * ny + (cj * 8 + (xy & 7))) * nz + (size_t)ck * 128 + z;
    vol.load(addr, s_t[xy * TD_ZS + z], s_w[xy * TD_ZS + z]);
  }
  if (halo && tid < 64) {
    const size_t addr =
        ((size_t)(ci * 8 + (tid >> 3)) * ny + (cj * 8 + (tid & 7))) * nz + (size_t)ck * 128 + 128;
    vol.load(addr, s_t[tid * TD_ZS + 128], s_w[tid * TD_ZS + 128]);
  }
  if (tid < HS_N_FIELDS * HS_NSUB) s_fields[tid >> 4][tid & 15] = 0.0f;
  __syncthreads();

  HsFitGeom g;
  g.ci = ci;
  g.cj = cj;
  g.z_base = 0.0f;
  g.sid_base = ((long long)ci * (int)p[24] + cj) * (nz / 8);
  g.vs = p[17];
  g.ox = p[18];
  g.oy = p[19];
  g.oz = p[20];
  g.min_count = 6.0f;
  hs_fit_subblock_warp(HsSmemChunk{s_t, s_w, TD_ZS}, warp, lane, halo ? 128 : 127, g,
                       (float)(ck * HS_NSUB + warp), s_fields);
  __syncthreads();
  if (tid < HS_N_FIELDS * HS_NSUB) {
    const int f = tid >> 4, s = tid & 15;
    planes[((size_t)(ci * nby + cj) * HS_N_FIELDS + f) * 128 + ck * HS_NSUB + s] = s_fields[f][s];
  }
}

// vol: the (2, nx, ny, nz) float32 array, updated in place; planes: the
// (nx / 8, ny / 8, 16, 128) output, zero where nothing is written (lanes
// past nz / 8); cls: (nx / 8) (ny / 8) (nz / 128) chunk classes.
extern "C" int hs_tsdf_dense(float* vol, int nx, int ny, int nz, const float* mip0, int h0,
                             int w0, const float* mip1, int h1, int w1, const float* mip2, int h2,
                             int w2, const float* l3, int h3, int w3, const float* l3min,
                             const float* l3max, const float* l3valid, const float* params,
                             int* cls, float* planes, void* stream) {
  const int n_chunks = (nx / 8) * (ny / 8) * (nz / 128);
  if (n_chunks <= 0) return 0;
  TdMips mips;
  mips.m[0] = mip0; mips.h[0] = h0; mips.w[0] = w0;
  mips.m[1] = mip1; mips.h[1] = h1; mips.w[1] = w1;
  mips.m[2] = mip2; mips.h[2] = h2; mips.w[2] = w2;
  mips.m[3] = l3; mips.h[3] = h3; mips.w[3] = w3;
  mips.l3min = l3min;
  mips.l3max = l3max;
  mips.l3valid = l3valid;
  const HsPlanar<float> st{vol, (size_t)nx * ny * nz};
  const cudaStream_t s = (cudaStream_t)stream;
  tsdf_dense_kernel<<<n_chunks, TD_THREADS, 0, s>>>(st, ny, nz, mips, params, cls);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int smem = 2 * 64 * TD_ZS * (int)sizeof(float);
  e = cudaFuncSetAttribute(tsdf_dense_fit_kernel<HsPlanar<float>>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  tsdf_dense_fit_kernel<<<n_chunks, TD_THREADS, smem, s>>>(st, planes, ny, nz, params);
  return (int)cudaGetLastError();
}

// Resident blocks an SM: out[0] the integrate, out[1] the column fit.
extern "C" int hs_tsdf_dense_occupancy(int, int* out) {
  const int e = hs_occupancy(tsdf_dense_kernel<HsPlanar<float>>, TD_THREADS, 0, out);
  return e ? e : hs_occupancy(tsdf_dense_fit_kernel<HsPlanar<float>>, TD_THREADS,
                              2 * 64 * TD_ZS * (int)sizeof(float), out + 1);
}
