// K4: work-list TSDF integrate + persistent sub-block plane refit
// (replaces housescan_tpu/ops/tsdf_stream.py _kernel + _process_half via
// tsdf_integrate_stream). See housescan_tpu_torch/ops/tsdf_stream.py for
// the plain version and the design note.
//
// One block of 512 threads per listed (8, 8, 128) chunk; the grid spans
// every chunk of the descriptor list and blocks past the device-side
// count return at once. Thread t owns z = t % 128 and the 16 voxels
// (ix, iy) with ix * 8 + iy = t / 128 + 4 k, so every warp reads 32
// consecutive z and belongs to one z-quarter (warp % 4).
//   1. REFINE only: per-voxel in-view bbox -> mip level and window;
//   2. BAND/REFINE: window all-valid test (every pixel > 0);
//   3. read-modify-write of the voxels by class; the tsdf as stored and
//      the weight also go to 64 KB of dynamic shared memory;
//   4. flags: zero-crossing possible, per-quarter free-space saturation,
//      any observed negative (from the unrounded updated values);
//   5. planes: one warp per (8, 8, 8) sub-block (planes.cuh), written with
//      the flags into field 11.
// The kernel is templated on the volume store (common.cuh): the packed
// int32 grid (32 KB in and out per chunk; the fit reads the quantized
// values) or the float32 (2, X, Y, Z) array (64 KB in and out; the fit
// reads the stored floats). One kernel, one set of math.
#include "common.cuh"
#include "planes.cuh"

#define TS_THREADS 512
#define TS_VOX 8192
#define TS_BIG 1.0e9f

enum { CLS_FREE = 0, CLS_BAND = 1, CLS_REFINE = 3 };

struct TsMips {
  const float* m[4];
  int h[4];
  int w[4];
};

template <class Store>
__global__ void __launch_bounds__(TS_THREADS)
tsdf_stream_kernel(Store vol, float* __restrict__ planes,
                   const int* __restrict__ desc, const int* __restrict__ count, int ny, int nz,
                   TsMips mips, const float* __restrict__ p, float sat_w) {
  if ((int)blockIdx.x >= *count) return;
  extern __shared__ float s_tw[];  // [0, 8192): tsdf, [8192, 16384): weight
  float* s_t = s_tw;
  float* s_w = s_tw + TS_VOX;
  __shared__ float s_red[8][TS_THREADS / 32];
  __shared__ float s_fields[HS_N_FIELDS][HS_NSUB];
  __shared__ int s_win[4];  // level, v0, u0, all_valid

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int* d = desc + (size_t)blockIdx.x * 8;
  const int ci = d[0], cj = d[1], ck = d[2], cls = d[3];
  const float trunc = p[16], max_weight = p[21];
  const int z = tid & 127;

  // 1. REFINE: the in-view bbox over every voxel chooses level and window
  if (cls == CLS_REFINE) {
    float umin = TS_BIG, umax = -TS_BIG, vmin = TS_BIG, vmax = -TS_BIG;
    for (int k = 0; k < 16; ++k) {
      const int xy = (tid >> 7) + 4 * k;
      HsVoxel c;
      hs_voxel_coords(p, ci, cj, ck, xy >> 3, xy & 7, z, c);
      if (c.iv > 0.5f) {
        umin = fminf(umin, c.uf);
        umax = fmaxf(umax, c.uf);
        vmin = fminf(vmin, c.vf);
        vmax = fmaxf(vmax, c.vf);
      }
    }
    umin = hs_warp_min(umin);
    umax = hs_warp_max(umax);
    vmin = hs_warp_min(vmin);
    vmax = hs_warp_max(vmax);
    if (lane == 0) {
      s_red[0][warp] = umin;
      s_red[1][warp] = umax;
      s_red[2][warp] = vmin;
      s_red[3][warp] = vmax;
    }
    __syncthreads();
    if (tid == 0) {
      for (int w8 = 1; w8 < TS_THREADS / 32; ++w8) {
        umin = fminf(umin, s_red[0][w8]);
        umax = fmaxf(umax, s_red[1][w8]);
        vmin = fminf(vmin, s_red[2][w8]);
        vmax = fmaxf(vmax, s_red[3][w8]);
      }
      const float span_u = umax - umin, span_v = vmax - vmin;
      int lvl = 3;
      for (int l = 2; l >= 0; --l) {
        const float s = (float)(1 << l);
        if (span_v <= 22.0f * s && span_u <= 60.0f * s) lvl = l;
      }
      const float sc = (float)(1 << lvl);
      const int hs = mips.h[lvl < 3 ? lvl : 2], ws = mips.w[lvl < 3 ? lvl : 2];
      s_win[0] = lvl;
      s_win[1] = min(max(((int)(vmin / sc) - 1) & ~7, 0), hs - 32);
      s_win[2] = min(max(((int)(umin / sc) - 1) & ~63, 0), ws - 128);
    }
  } else if (tid == 0) {
    s_win[0] = d[4];
    s_win[1] = d[5];
    s_win[2] = d[6];
  }
  __syncthreads();
  const int lvl = s_win[0];
  const int v0 = lvl < 3 ? s_win[1] : 0;
  const int u0 = lvl < 3 ? s_win[2] : 0;
  const float* mip = mips.m[lvl];
  const int mw = mips.w[lvl];
  const int nrows = lvl < 3 ? 32 : mips.h[3];
  const int win_u = lvl < 3 ? 128 : mips.w[3];

  // 2. the window's all-valid test decides between plain and renormalised
  bool all_valid = true;
  if (cls != CLS_FREE) {
    bool pos = true;
    for (int i = tid; i < nrows * win_u; i += TS_THREADS)
      pos = pos && (mip[(v0 + i / win_u) * mw + u0 + i % win_u] > 0.0f);
    all_valid = __syncthreads_and(pos) != 0;
  }

  // 3. read-modify-write
  const float scale = (float)(1 << lvl);
  const float v0f = (float)v0, u0f = (float)u0;
  float mn_t = 1.0f, mx_t = -1.0f, q_minw = TS_BIG, q_mint = 1.0f, q_maxw = -1.0f;
  for (int k = 0; k < 16; ++k) {
    const int xy = (tid >> 7) + 4 * k;
    const int ix = xy >> 3, iy = xy & 7;
    const size_t addr = ((size_t)(ci * 8 + ix) * ny + (cj * 8 + iy)) * nz + (size_t)ck * 128 + z;
    float told, wold;
    vol.load(addr, told, wold);
    HsVoxel c;
    hs_voxel_coords(p, ci, cj, ck, ix, iy, z, c);
    bool update;
    float sample;
    if (cls == CLS_FREE) {
      update = c.iv_free > 0.5f;
      sample = 1.0f;
    } else {
      float uw = c.uf / scale - u0f;
      uw = rintf(uw * 256.0f) * (1.0f / 256.0f);
      const float vw = c.vf / scale - v0f;
      const bool support = (uw >= 0.0f) && (uw <= (float)(win_u - 1)) && (vw >= 0.0f) &&
                           (vw <= (float)(nrows - 1));
      const float c0f = floorf(uw), r0f = floorf(vw);
      const float wc0 = hs_clamp_min(1.0f - fabsf(uw - c0f), 0.0f);
      const float wc1 = hs_clamp_min(1.0f - fabsf(uw - (c0f + 1.0f)), 0.0f);
      const float wr0 = hs_clamp_min(1.0f - fabsf(vw - r0f), 0.0f);
      const float wr1 = hs_clamp_min(1.0f - fabsf(vw - (r0f + 1.0f)), 0.0f);
      const int c0 = (int)hs_clamp_max(hs_clamp_min(c0f, 0.0f), (float)(win_u - 1));
      const int r0 = (int)hs_clamp_max(hs_clamp_min(r0f, 0.0f), (float)(nrows - 1));
      const int c1 = min(c0 + 1, win_u - 1), r1 = min(r0 + 1, nrows - 1);
      const float* row0 = mip + (size_t)(v0 + r0) * mw + u0;
      const float* row1 = mip + (size_t)(v0 + r1) * mw + u0;
      const float p00 = __ldg(row0 + c0), p01 = __ldg(row0 + c1);
      const float p10 = __ldg(row1 + c0), p11 = __ldg(row1 + c1);
      const float num = (p00 * wc0 + p01 * wc1) * wr0 + (p10 * wc0 + p11 * wc1) * wr1;
      const float q00 = p00 > 0.0f ? 1.0f : 0.0f, q01 = p01 > 0.0f ? 1.0f : 0.0f;
      const float q10 = p10 > 0.0f ? 1.0f : 0.0f, q11 = p11 > 0.0f ? 1.0f : 0.0f;
      const float den = (q00 * wc0 + q01 * wc1) * wr0 + (q10 * wc0 + q11 * wc1) * wr1;
      const float depth = all_valid ? num : num / hs_clamp_min(den, 1e-12f);
      const bool has = support && (all_valid || den > 1e-6f);
      const float sdf = depth - c.zc;
      update = (c.iv > 0.5f) && has && (sdf >= -trunc);
      sample = hs_clamp_max(hs_clamp_min(sdf / trunc, -1.0f), 1.0f);
    }
    const float wadd = update ? 1.0f : 0.0f;
    const float wnew = fminf(wold + wadd, max_weight);
    const float denom = hs_clamp_min(wold + wadd, 1.0f);
    const float tnew = (told * wold + sample * wadd) / denom;
    const float tcur = update ? tnew : told;
    const int o = (ix * 8 + iy) * 128 + z;
    s_t[o] = vol.store(addr, tcur, wnew);
    s_w[o] = wnew;
    const bool obs = wnew > 0.0f;
    mn_t = fminf(mn_t, obs ? tcur : 1.0f);
    mx_t = fmaxf(mx_t, obs ? tcur : -1.0f);
    q_minw = fminf(q_minw, obs ? wnew : TS_BIG);
    q_mint = fminf(q_mint, obs ? tcur : 1.0f);
    q_maxw = fmaxf(q_maxw, wnew);
  }

  // 4. flags (min/max are exact in any order)
  mn_t = hs_warp_min(mn_t);
  mx_t = hs_warp_max(mx_t);
  q_minw = hs_warp_min(q_minw);
  q_mint = hs_warp_min(q_mint);
  q_maxw = hs_warp_max(q_maxw);
  __syncthreads();  // s_red may still be read by the bbox reduction
  if (lane == 0) {
    s_red[0][warp] = mn_t;
    s_red[1][warp] = mx_t;
    s_red[2][warp] = q_minw;
    s_red[3][warp] = q_mint;
    s_red[4][warp] = q_maxw;
  }
  __syncthreads();
  if (tid < HS_N_FIELDS * HS_NSUB) s_fields[tid >> 4][tid & 15] = 0.0f;
  __syncthreads();
  if (tid == 0) {
    float a = s_red[0][0], b = s_red[1][0];
    for (int w8 = 1; w8 < TS_THREADS / 32; ++w8) {
      a = fminf(a, s_red[0][w8]);
      b = fmaxf(b, s_red[1][w8]);
    }
    for (int q = 0; q < 4; ++q) {
      float minw = TS_BIG, mint = TS_BIG, maxw = -1.0f;
      for (int w8 = q; w8 < TS_THREADS / 32; w8 += 4) {
        minw = fminf(minw, s_red[2][w8]);
        mint = fminf(mint, s_red[3][w8]);
        maxw = fmaxf(maxw, s_red[4][w8]);
      }
      s_fields[11][q] = (minw >= sat_w && mint > 0.999f && maxw > 0.0f) ? 1.0f : 0.0f;
    }
    s_fields[11][4] = a < 0.0f ? 1.0f : 0.0f;
    s_win[3] = (a < 0.0f && b >= 0.0f) ? 1 : 0;
  }
  __syncthreads();

  // 5. planes: warp s fits sub-block s (z in [8s, 8s + 8))
  if (s_win[3]) {
    HsFitGeom g;
    g.ci = ci;
    g.cj = cj;
    g.z_base = (float)(ck * 128);
    g.sid_base = (((long long)ci * (int)p[24] + cj) * (int)p[25] + ck) * HS_NSUB;
    g.vs = p[17];
    g.ox = p[18];
    g.oy = p[19];
    g.oz = p[20];
    g.min_count = 6.0f;
    hs_fit_subblock_warp(HsSmemChunk{s_t, s_w, 128}, warp, lane, 127, g, (float)warp, s_fields);
    __syncthreads();
  }
  if (tid < HS_N_FIELDS * HS_NSUB) {
    const size_t chunk = ((size_t)ci * (ny / 8) + cj) * (nz / 128) + ck;
    planes[chunk * HS_N_FIELDS * HS_NSUB + tid] = s_fields[tid >> 4][tid & 15];
  }
}

template <class Store>
static int ts_launch(Store vol, float* planes, const int* desc, const int* count, int n_desc,
                     int ny, int nz, const TsMips& mips, const float* params, float sat_w,
                     cudaStream_t stream) {
  const int smem = 2 * TS_VOX * (int)sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(tsdf_stream_kernel<Store>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  tsdf_stream_kernel<Store><<<n_desc, TS_THREADS, smem, stream>>>(vol, planes, desc, count, ny,
                                                                  nz, mips, params, sat_w);
  return (int)cudaGetLastError();
}

// layout: HS_LAYOUT_PACKED (vol is the (nx, ny, nz) int32 grid) or
// HS_LAYOUT_F32 (vol is the (2, nx, ny, nz) float32 array).
extern "C" int hs_tsdf_stream(void* vol, int layout, float* planes, const int* desc,
                              const int* count, int n_desc, int nx, int ny, int nz,
                              const float* mip0, int h0, int w0, const float* mip1, int h1,
                              int w1, const float* mip2, int h2, int w2, const float* l3, int h3,
                              int w3, const float* params, float sat_w, void* stream) {
  if (n_desc <= 0) return 0;
  TsMips mips;
  mips.m[0] = mip0; mips.h[0] = h0; mips.w[0] = w0;
  mips.m[1] = mip1; mips.h[1] = h1; mips.w[1] = w1;
  mips.m[2] = mip2; mips.h[2] = h2; mips.w[2] = w2;
  mips.m[3] = l3; mips.h[3] = h3; mips.w[3] = w3;
  const cudaStream_t st = (cudaStream_t)stream;
  if (layout == HS_LAYOUT_PACKED)
    return ts_launch(HsPacked{(int*)vol}, planes, desc, count, n_desc, ny, nz, mips, params,
                     sat_w, st);
  if (layout == HS_LAYOUT_F32)
    return ts_launch(HsPlanar<float>{(float*)vol, (size_t)nx * ny * nz}, planes, desc, count,
                     n_desc, ny, nz, mips, params, sat_w, st);
  return (int)cudaErrorInvalidValue;
}
