// K4: work-list TSDF integrate + persistent sub-block plane refit
// (replaces housescan_tpu/ops/tsdf_stream.py _kernel + _process_half via
// tsdf_integrate_stream). See housescan_tpu_torch/ops/tsdf_stream.py for
// the plain version and the design note.
//
// Bound: bytes. Each listed chunk is read and written once (packed and
// bfloat16: 32 KB each way, float32: 64 KB) with its 1 KB planes tile; the mips are read
// once (L2-resident). The arithmetic (~60 float operations a voxel, the
// plane fit's moments) is below that.
//
// Design. A persistent grid (the wrapper's stream_grid: at most the
// resident blocks an SM times the SMs) walks the work list, block b taking
// rows b, b + grid, ... up to the device-side count, so the host never
// reads the list length and no block is scheduled for an unlisted chunk.
// Each block stages its chunk in shared memory with Hopper's asynchronous
// bulk copies (one 512-byte z-row a copy, issued from every warp,
// completing on an mbarrier), two stages deep: the next chunk's rows
// arrive while this one is integrated and fitted. Block of 512 threads;
// thread t owns z = t % 128 and the 16 voxels (ix, iy) with ix * 8 + iy =
// t / 128 + 4 k, so every warp covers 32 consecutive z of one z-quarter
// (warp % 4). Per chunk:
//   1. REFINE only: per-voxel in-view bbox (warp min/max, then warp 0
//      over the warps) -> mip level and window;
//   2. BAND/REFINE: window all-valid test (every pixel > 0), every load
//      issued at once, no short-circuit;
//   3. wait for the staged chunk, read-modify-write of the voxels by
//      class (FREE needs no division; a voxel not updated skips its
//      divisions): each new cell goes to the volume and, in place, to the
//      staged copy;
//   4. flags: zero-crossing possible, per-quarter free-space saturation,
//      any observed negative (from the unrounded updated values; warp
//      reductions, then warp 0 over the 16 warps);
//   5. planes: one warp per (8, 8, 8) sub-block (planes.cuh), reading the
//      staged copy through HsStagedChunk (the stored values: quantized when
//      packed), written with the flags into field 11.
// Registers: __launch_bounds__(512, 1), one block an SM on every layout
// (the stages take 70 KB packed and bfloat16, 139 KB float32), no spills.
// The kernel is templated on the volume store (common.cuh): the packed
// int32 grid, or the (2, X, Y, Z) array in float32 or bfloat16 (2-byte
// cells: a staged row is 272 bytes). One kernel, one set of math, float32
// on every layout.
//
// An X-slab of a sharded volume (parallel/sharded.py) passes its first
// global X block in params[26] and the global X block count in
// params[24]: world x and the sub-block ids take ci + block_x0, while the
// slab's data and planes are indexed by the local ci, so every float of a
// slab is what the whole volume computes for that chunk.
#include "common.cuh"
#include "planes.cuh"

#define TS_THREADS 512
#define TS_WARPS (TS_THREADS / 32)
#define TS_BIG 1.0e9f

enum { CLS_FREE = 0, CLS_BAND = 1, CLS_REFINE = 3 };

struct TsMips {
  const float* m[4];
  int h[4];
  int w[4];
};

// Shared memory of one staged chunk of a Store, in bytes.
template <class Store>
__host__ __device__ constexpr int ts_stage_bytes() {
  return Store::kPlanes * HS_STAGE_PLANE * Store::kCellBytes;
}

// The whole block: stage chunk row ``c`` of the list into ``dst``, one
// bulk copy a 128-cell z-row, the rows spread over the warps (the first
// lanes of each), counted on ``bar``; thread 0 arrives expecting the
// chunk's bytes (a copy may land first: the phase cannot complete before
// that arrival).
template <class Store>
__device__ __forceinline__ void ts_stage(const Store& vol, const int* desc, int c, int ny, int nz,
                                         unsigned char* dst, uint64_t* bar, int tid) {
  constexpr int kRowBytes = 128 * Store::kCellBytes;
  constexpr int kRowStride = HS_STAGE_ROW * Store::kCellBytes;
  constexpr int kPerWarp = 64 * Store::kPlanes / TS_WARPS;
  const int lane = tid & 31;
  if (tid == 0) hs_mbar_expect_tx(bar, 64 * Store::kPlanes * kRowBytes);
  if (lane < kPerWarp) {
    const int* d = desc + (size_t)c * 8;
    const int r = (tid >> 5) * kPerWarp + lane;
    const int xy = r & 63;
    const size_t a = ((size_t)(d[0] * 8 + (xy >> 3)) * ny + (d[1] * 8 + (xy & 7))) * nz +
                     (size_t)d[2] * 128;
    hs_fence_proxy_async();
    hs_bulk_load(dst + (size_t)r * kRowStride, vol.plane_ptr(a, r >> 6), kRowBytes, bar);
  }
}

template <class Store>
__global__ void __launch_bounds__(TS_THREADS, 1)
tsdf_stream_kernel(Store vol, float* __restrict__ planes,
                   const int* __restrict__ desc, const int* __restrict__ count, int ny, int nz,
                   TsMips mips, const float* __restrict__ p, float sat_w) {
  constexpr int kStage = ts_stage_bytes<Store>();
  extern __shared__ __align__(128) unsigned char s_stage[];  // two stages
  __shared__ __align__(8) uint64_t s_bar[2];
  __shared__ float s_red[5][TS_WARPS];
  __shared__ float s_fields[HS_N_FIELDS][HS_NSUB];
  __shared__ int s_win[4];  // level, v0, u0, may cross

  const int n = *count;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float trunc = p[16], max_weight = p[21];
  const int bx0 = (int)p[26];  // the slab's first global X block (0: whole volume)
  const int z = tid & 127;

  if (tid == 0) {
    hs_mbar_init(&s_bar[0], 1);
    hs_mbar_init(&s_bar[1], 1);
  }
  __syncthreads();
  if ((int)blockIdx.x < n) ts_stage(vol, desc, blockIdx.x, ny, nz, s_stage, &s_bar[0], tid);

  int k = 0;
  for (int c = blockIdx.x; c < n; c += gridDim.x, ++k) {
    const int s = k & 1;
    unsigned char* stage = s_stage + s * kStage;
    // the next chunk's rows go to the other stage, free since the last
    // barrier of the chunk before this one
    if (c + (int)gridDim.x < n)
      ts_stage(vol, desc, c + gridDim.x, ny, nz, s_stage + (s ^ 1) * kStage, &s_bar[s ^ 1], tid);
    const int* d = desc + (size_t)c * 8;
    const int ci = d[0], cj = d[1], ck = d[2], cls = d[3];

    // 1. REFINE: the in-view bbox over every voxel chooses level and window
    if (cls == CLS_REFINE) {
      float umin = TS_BIG, umax = -TS_BIG, vmin = TS_BIG, vmax = -TS_BIG;
      for (int kk = 0; kk < 16; ++kk) {
        const int xy = (tid >> 7) + 4 * kk;
        HsVoxel vc;
        hs_voxel_coords(p, ci + bx0, cj, ck, xy >> 3, xy & 7, z, vc);
        if (vc.iv > 0.5f) {
          umin = fminf(umin, vc.uf);
          umax = fmaxf(umax, vc.uf);
          vmin = fminf(vmin, vc.vf);
          vmax = fmaxf(vmax, vc.vf);
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
      if (warp == 0) {
        const bool w_ok = lane < TS_WARPS;
        umin = hs_warp_min(w_ok ? s_red[0][lane] : TS_BIG);
        umax = hs_warp_max(w_ok ? s_red[1][lane] : -TS_BIG);
        vmin = hs_warp_min(w_ok ? s_red[2][lane] : TS_BIG);
        vmax = hs_warp_max(w_ok ? s_red[3][lane] : -TS_BIG);
        if (lane == 0) {
          const float span_u = umax - umin, span_v = vmax - vmin;
          int lvl = 3;
          for (int l = 2; l >= 0; --l) {
            const float sl = (float)(1 << l);
            if (span_v <= 22.0f * sl && span_u <= 60.0f * sl) lvl = l;
          }
          const float sc = (float)(1 << lvl);
          const int hs = mips.h[lvl < 3 ? lvl : 2], ws = mips.w[lvl < 3 ? lvl : 2];
          s_win[0] = lvl;
          s_win[1] = min(max(((int)(vmin / sc) - 1) & ~7, 0), hs - 32);
          s_win[2] = min(max(((int)(umin / sc) - 1) & ~63, 0), ws - 128);
        }
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
    // (win_u is a multiple of 128: thread t takes column t % 128 of rows
    // t / 128 + 4 j; a 32 x 128 window's 8 loads all issued at once)
    bool all_valid = true;
    if (cls != CLS_FREE) {
      bool pos = true;
      const float* col = mip + (size_t)(v0 + (tid >> 7)) * mw + u0 + (tid & 127);
      if (lvl < 3) {
#pragma unroll
        for (int j = 0; j < 32 / (TS_THREADS / 128); ++j)
          pos &= __ldg(col + (size_t)j * (TS_THREADS / 128) * mw) > 0.0f;
      } else {
        for (int r = tid >> 7; r < nrows; r += TS_THREADS / 128)
          for (int u = tid & 127; u < win_u; u += 128)
            pos &= __ldg(mip + (size_t)(v0 + r) * mw + u0 + u) > 0.0f;
      }
      all_valid = __syncthreads_and(pos) != 0;
    }

    // 3. read-modify-write from the staged chunk. Thread t's voxels are
    // (ix, iy) for every ix and iy = t / 128 and t / 128 + 4, in that
    // order: the camera-space terms of its z and of its two y are formed
    // once, those of x once an ix, and added as hs_voxel_cam adds them
    hs_mbar_wait(&s_bar[s], (k >> 1) & 1);
    // x / 2^l is x * 2^-l exactly: the window scale multiplies
    const float inv_scale = 1.0f / (float)(1 << lvl);
    const float v0f = (float)v0, u0f = (float)u0;
    const HsAxisTerms cz = hs_voxel_axis(p, 2, ck * 128, z);
    HsAxisTerms by[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) by[h] = hs_voxel_axis(p, 1, cj * 8, (tid >> 7) + 4 * h);
    float mn_t = 1.0f, mx_t = -1.0f, q_minw = TS_BIG, q_mint = 1.0f, q_maxw = -1.0f;
    for (int ix = 0; ix < 8; ++ix) {
      const HsAxisTerms ax = hs_voxel_axis(p, 0, (ci + bx0) * 8, ix);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int iy = (tid >> 7) + 4 * h;
        const int o = (ix * 8 + iy) * HS_STAGE_ROW + z;
        const float xc = ax.c0 + by[h].c0 + cz.c0, yc = ax.c1 + by[h].c1 + cz.c1,
                    zc = ax.c2 + by[h].c2 + cz.c2;
        float told, wold;
        Store::staged_load(stage, o, told, wold);
        bool update;
        float sample;
        if (cls == CLS_FREE) {
          update = hs_in_view_free(p, xc, yc, zc);
          sample = 1.0f;
        } else {
          HsVoxel vc;
          hs_voxel_project(p, xc, yc, zc, vc);
          float uw = vc.uf * inv_scale - u0f;
          uw = rintf(uw * 256.0f) * (1.0f / 256.0f);
          const float vw = vc.vf * inv_scale - v0f;
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
          float depth = num;
          if (!all_valid) depth = num / hs_clamp_min(den, 1e-12f);  // uniform in the block
          const bool has = support && (all_valid || den > 1e-6f);
          const float sdf = depth - vc.zc;
          update = (vc.iv > 0.5f) && has && (sdf >= -trunc);
          sample = update ? hs_clamp_max(hs_clamp_min(sdf / trunc, -1.0f), 1.0f) : 0.0f;
        }
        // a voxel that is not updated keeps its cell: the divisions are skipped
        const float wadd = update ? 1.0f : 0.0f;
        const float wnew = fminf(wold + wadd, max_weight);
        float tcur = told;
        if (update) tcur = (told * wold + sample * wadd) / hs_clamp_min(wold + wadd, 1.0f);
        const size_t addr =
            ((size_t)(ci * 8 + ix) * ny + (cj * 8 + iy)) * nz + (size_t)ck * 128 + z;
        vol.store_staged(stage, o, addr, tcur, wnew);
        const bool obs = wnew > 0.0f;
        mn_t = fminf(mn_t, obs ? tcur : 1.0f);
        mx_t = fmaxf(mx_t, obs ? tcur : -1.0f);
        q_minw = fminf(q_minw, obs ? wnew : TS_BIG);
        q_mint = fminf(q_mint, obs ? tcur : 1.0f);
        q_maxw = fmaxf(q_maxw, wnew);
      }
    }

    // 4. flags (min/max are exact in any order)
    mn_t = hs_warp_min(mn_t);
    mx_t = hs_warp_max(mx_t);
    q_minw = hs_warp_min(q_minw);
    q_mint = hs_warp_min(q_mint);
    q_maxw = hs_warp_max(q_maxw);
    if (lane == 0) {
      s_red[0][warp] = mn_t;
      s_red[1][warp] = mx_t;
      s_red[2][warp] = q_minw;
      s_red[3][warp] = q_mint;
      s_red[4][warp] = q_maxw;
    }
    if (tid < HS_N_FIELDS * HS_NSUB) s_fields[tid >> 4][tid & 15] = 0.0f;
    __syncthreads();
    if (warp == 0) {
      // lane l < 16 holds warp l; warp l covers z-quarter l % 4, so xor 4
      // and 8 reduce a quarter, and xor 1 and 2 then the whole chunk
      const bool w_ok = lane < TS_WARPS;
      float a = w_ok ? s_red[0][lane] : 1.0f, b = w_ok ? s_red[1][lane] : -1.0f;
      float minw = w_ok ? s_red[2][lane] : TS_BIG, mint = w_ok ? s_red[3][lane] : TS_BIG;
      float maxw = w_ok ? s_red[4][lane] : -1.0f;
      for (int o = 4; o <= 8; o <<= 1) {
        a = fminf(a, __shfl_xor_sync(HS_FULL_MASK, a, o));
        b = fmaxf(b, __shfl_xor_sync(HS_FULL_MASK, b, o));
        minw = fminf(minw, __shfl_xor_sync(HS_FULL_MASK, minw, o));
        mint = fminf(mint, __shfl_xor_sync(HS_FULL_MASK, mint, o));
        maxw = fmaxf(maxw, __shfl_xor_sync(HS_FULL_MASK, maxw, o));
      }
      if (lane < 4)
        s_fields[11][lane] = (minw >= sat_w && mint > 0.999f && maxw > 0.0f) ? 1.0f : 0.0f;
      for (int o = 1; o <= 2; o <<= 1) {
        a = fminf(a, __shfl_xor_sync(HS_FULL_MASK, a, o));
        b = fmaxf(b, __shfl_xor_sync(HS_FULL_MASK, b, o));
      }
      if (lane == 0) {
        s_fields[11][4] = a < 0.0f ? 1.0f : 0.0f;
        s_win[3] = (a < 0.0f && b >= 0.0f) ? 1 : 0;
      }
    }
    __syncthreads();

    // 5. planes: warp s fits sub-block s (z in [8s, 8s + 8)) from the stage
    if (s_win[3]) {
      HsFitGeom g;
      g.ci = ci + bx0;
      g.cj = cj;
      g.z_base = (float)(ck * 128);
      g.sid_base = (((long long)(ci + bx0) * (int)p[24] + cj) * (int)p[25] + ck) * HS_NSUB;
      g.vs = p[17];
      g.ox = p[18];
      g.oy = p[19];
      g.oz = p[20];
      g.min_count = 6.0f;
      hs_fit_subblock_warp(HsStagedChunk<Store>{stage}, warp, lane, 127, g, (float)warp,
                           s_fields);
      __syncthreads();
    }
    if (tid < HS_N_FIELDS * HS_NSUB) {
      const size_t chunk = ((size_t)ci * (ny / 8) + cj) * (nz / 128) + ck;
      planes[chunk * HS_N_FIELDS * HS_NSUB + tid] = s_fields[tid >> 4][tid & 15];
    }
  }
}

template <class Store>
static int ts_launch(Store vol, float* planes, const int* desc, const int* count, int grid,
                     int ny, int nz, const TsMips& mips, const float* params, float sat_w,
                     cudaStream_t stream) {
  const int smem = 2 * ts_stage_bytes<Store>();
  cudaError_t e = cudaFuncSetAttribute(tsdf_stream_kernel<Store>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  tsdf_stream_kernel<Store><<<grid, TS_THREADS, smem, stream>>>(vol, planes, desc, count, ny, nz,
                                                                mips, params, sat_w);
  return (int)cudaGetLastError();
}

// layout: HS_LAYOUT_PACKED (vol is the (nx, ny, nz) int32 grid),
// HS_LAYOUT_F32 or HS_LAYOUT_BF16 (vol is the (2, nx, ny, nz) float32 or
// bfloat16 array); grid: the persistent grid (ops/tsdf_stream.stream_grid).
extern "C" int hs_tsdf_stream(void* vol, int layout, float* planes, const int* desc,
                              const int* count, int grid, int nx, int ny, int nz,
                              const float* mip0, int h0, int w0, const float* mip1, int h1,
                              int w1, const float* mip2, int h2, int w2, const float* l3, int h3,
                              int w3, const float* params, float sat_w, void* stream) {
  if (grid <= 0) return 0;
  TsMips mips;
  mips.m[0] = mip0; mips.h[0] = h0; mips.w[0] = w0;
  mips.m[1] = mip1; mips.h[1] = h1; mips.w[1] = w1;
  mips.m[2] = mip2; mips.h[2] = h2; mips.w[2] = w2;
  mips.m[3] = l3; mips.h[3] = h3; mips.w[3] = w3;
  const cudaStream_t st = (cudaStream_t)stream;
  if (layout == HS_LAYOUT_PACKED)
    return ts_launch(HsPacked{(int*)vol}, planes, desc, count, grid, ny, nz, mips, params, sat_w,
                     st);
  if (layout == HS_LAYOUT_F32)
    return ts_launch(HsPlanar<float>{(float*)vol, (size_t)nx * ny * nz}, planes, desc, count,
                     grid, ny, nz, mips, params, sat_w, st);
  if (layout == HS_LAYOUT_BF16)
    return ts_launch(HsPlanar<__nv_bfloat16>{(__nv_bfloat16*)vol, (size_t)nx * ny * nz}, planes,
                     desc, count, grid, ny, nz, mips, params, sat_w, st);
  return (int)cudaErrorInvalidValue;
}

// Resident blocks an SM: out[0] packed, out[1] float32, out[2] bfloat16.
extern "C" int hs_tsdf_stream_occupancy(int, int* out) {
  int e = hs_occupancy(tsdf_stream_kernel<HsPacked>, TS_THREADS,
                       2 * ts_stage_bytes<HsPacked>(), out);
  if (!e)
    e = hs_occupancy(tsdf_stream_kernel<HsPlanar<float>>, TS_THREADS,
                     2 * ts_stage_bytes<HsPlanar<float>>(), out + 1);
  return e ? e
           : hs_occupancy(tsdf_stream_kernel<HsPlanar<__nv_bfloat16>>, TS_THREADS,
                          2 * ts_stage_bytes<HsPlanar<__nv_bfloat16>>(), out + 2);
}
