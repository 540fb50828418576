// K8: the first-generation dense TSDF integrate over (8, 8, R) columns with
// the fused column plane fit (replaces housescan_tpu/ops/tsdf_pallas.py
// _kernel, line 53, called at :443 by tsdf_integrate_with_planes). See
// housescan_tpu_torch/ops/tsdf_cuda.py for the plain version.
//
// Bound: device-memory bytes. The function needs every weight, the tsdf of
// the voxels observed before the frame (an unobserved voxel's is weighed by
// 0 and skipped by the fit), the changed words written, plus the frame, the
// planes and the classes; the arithmetic (~60 float operations a visited
// voxel, the fit's crossing tests) is below that. This kernel reads every
// voxel once (8 bytes) and writes only the changed cells.
//
// Design: ONE launch, a persistent grid (at most the resident blocks an SM
// times the SMs) of 512-thread blocks, block b starting on column b and
// claiming each next column from a counter (columns in view cost more than
// the rest), each column's R / 128 chunks in z order as one stream of
// items.
// Three chunk buffers in shared memory form a ring (3 x 68 KB: one block
// an SM): item t lives in buffer t % 3, staged with Hopper's bulk copies
// (one 512-byte z-row a copy, 128 a chunk) on mbarrier t % 3, issued two
// items ahead, so a chunk's bytes arrive while the two before it are
// integrated and fitted. For item t (chunk ck of its column):
//   1. classify, before its bytes are waited for (it needs none):
//      a. a conservative frustum test of the chunk's 8 corner voxels in
//         double (warp-redundant, once a column; td_cull_mask): a chunk
//         none of whose voxels can pass the in-view test is SKIP without a
//         per-voxel pass (the test keeps a margin far above the float32
//         error of the per-voxel projection, so it never drops a voxel the
//         plain version sees; it also holds for chunks that straddle the
//         camera plane);
//      b. else the reference's rules (tsdf_dense header of the plain
//         version): each thread projects its 16 voxels once (each axis's
//         camera terms hoisted, added x, y, z as hs_voxel_cam adds them)
//         and keeps (uf, vf, zc) in registers for step 3; the six extrema
//         in one warp pass, then the 24 x 128 L3 rectangle; SKIP, FREE or
//         BAND and the BAND window;
//   2. wait for item t's bytes;
//   3. FREE / BAND: read-modify-write in the staged copy (BAND: the
//      bilinear depth of every voxel in view first, then the cells); only
//      the cells whose value changes go back to device memory (a SKIP
//      chunk is read once, for the fit, and never written);
//   4. fit: chunk ck - 1 of the column (buffer (t - 1) % 3), its +z halo
//      read from chunk ck's first slice after its integrate, as the second
//      launch read it before; and chunk ck itself when it is the column's
//      last (z = R - 1 masked). Warp s first tests sub-block s's weights
//      with 16-byte loads: unobserved, its moments are all zero; else it
//      sums them in double (planes.cuh; an unobserved voxel reads no
//      neighbour) and lane 0 rounds them into shared memory. After one
//      barrier 16 lanes of one warp emit the 16 sub-blocks' fields side by
//      side and store the (16, 16) tile coalesced, while the other warps go
//      on; an unobserved sub-block takes the shape of all-zero moments,
//      computed once a block, so only observed ones run the eigen
//      analysis;
//   5. after that barrier buffer (t - 1) % 3 is free: item t + 2 is staged
//      into it.
// Each column's planes tile gets every lane: zeros past R / 8, so the
// wrapper allocates it without a fill. The params sit in shared memory, and
// the volume's copies and stores carry an L2 evict-first policy, so the
// small tables (mips, L3 maps) stay in L2 under the 1 GB stream.
//
// What holds it (chip_smoke.py on dense-512's compare input, NVIDIA H100
// 80GB HBM3: 0.53 ms against the 0.35 ms byte bound): a chunk in view
// keeps its block in the classifier and the read-modify-write, waiting on
// device memory, while the SM's one block has only two chunks of copies
// in flight, so the copy stream idles behind those chunks.
//
// The outputs are bit-identical to
// the plain version: the same float32 operations in the same order
// (--fmad=false), min / max exact in any order, and the fit's double sums
// in planes.cuh's order. CUDA C++ rather than Triton: the chunks are
// staged with bulk copies completing on mbarriers, through a persistent
// per-block pipeline over a shared-memory ring, and the fit is planes.cuh's,
// shared with K4 and K7.
#include "planes.cuh"

#define TD_THREADS 512
#define TD_WARPS (TD_THREADS / 32)
#define TD_BIG 1.0e9f
#define TD_L3_V 64    // rows of the L3 min / max / valid maps
#define TD_L3_U 128   // their columns
#define TD_RECT_V 24  // rows of the footprint rectangle
#define TD_WIN_V 32
#define TD_WIN_U 256
#define TD_ROW HS_STAGE_ROW                // cells a staged z-row (128 and padding)
#define TD_PLANE (64 * TD_ROW)             // a staged plane (tsdf or weight)
#define TD_BUF (2 * TD_PLANE)              // a staged chunk, in floats
#define TD_NBUF 3
#define TD_SMEM (TD_NBUF * TD_BUF * 4)     // dynamic shared memory, bytes
#define TD_MAX_NZC 8                       // R <= 1024
#define TD_NPARAM 26                       // params read (ops/tsdf_stream._stream_params)

enum { TD_SKIP = 0, TD_FREE = 1, TD_BAND = 2 };

struct TdMips {
  const float* m[4];  // L0, L1, L2 padded, then the (64, 256) L3 window
  int h[4];
  int w[4];
  const float* l3min;    // (64, 128): min valid depth of each 8x8 block (BIG if none)
  const float* l3max;    // (64, 128): max depth of each block
  const float* l3valid;  // (64, 128): 1 where every pixel of the block is valid
};

// A chunk with its +z halo in the ring: z < 128 from buffer ``a``, z = 128
// from the first slice of buffer ``b`` (offsets in floats into ``s``).
struct TdHaloChunk {
  const float* s;
  int a, b;
  __device__ __forceinline__ void operator()(int ix, int iy, int z, float& tv, float& wv) const {
    const int o = (ix * 8 + iy) * TD_ROW + z + (z < 128 ? a : b - 128);
    tv = s[o];
    wv = s[TD_PLANE + o];
  }
};

// The volume streams through L2 once: its copies and stores carry an
// evict-first policy, so the mips and the L3 maps, which every visited chunk
// reads, stay in L2 under the stream.
__device__ __forceinline__ uint64_t td_evict_first() {
  uint64_t pol;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;" : "=l"(pol));
  return pol;
}
__device__ __forceinline__ void td_store(float* a, float v, uint64_t pol) {
  asm volatile("st.global.L2::cache_hint.f32 [%0], %1, %2;" ::"l"(a), "f"(v), "l"(pol) : "memory");
}

// The whole block: stage chunk (ci, cj, ck) into buffer ``dst`` (offset in
// floats), one bulk copy a z-row of a plane, 8 rows a warp; thread 0
// arrives expecting the chunk's bytes.
__device__ __forceinline__ void td_stage(const float* vol, size_t plane, int ci, int cj, int ck,
                                         int ny, int nz, float* s, int dst, uint64_t* bar,
                                         int tid) {
  if (tid == 0) hs_mbar_expect_tx(bar, 2 * 64 * 128 * 4);
  const int lane = tid & 31;
  if (lane < 8) {
    const int r = (tid >> 5) * 8 + lane;  // plane r / 64, row r % 64
    const int xy = r & 63;
    const size_t a = (size_t)(r >> 6) * plane +
                     ((size_t)(ci * 8 + (xy >> 3)) * ny + (cj * 8 + (xy & 7))) * nz +
                     (size_t)ck * 128;
    hs_fence_proxy_async();
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes.L2::cache_hint"
        " [%0], [%1], %2, [%3], %4;" ::"r"(hs_smem_addr(s + dst + (r >> 6) * TD_PLANE + xy * TD_ROW)),
        "l"(vol + a), "r"(128 * 4), "r"(hs_smem_addr(bar)), "l"(td_evict_first())
        : "memory");
  }
}

// Bit c of the result: no voxel of chunk c of column (ci, cj) can pass the
// in-view test, from its 8 corner voxels in double, warp-redundant. A voxel
// with float zc <= 1e-6 fails it; one with zc > 1e-6 has uf < 0 wherever
// its float fx xc < -1.001 (cx + 1) zc (then fx xc / zc < -(cx + 1)
// beyond rounding), and likewise past the other three edges. Each side
// S = fx xc + 1.001 (cx + 1) zc (and the others) is affine in the voxel, so
// it is largest at a corner: if it stays below -margin at every corner, no
// voxel passes. The margin bounds the float32 error of both sides (camera
// coordinates within 9 eps M of exact, M the corner's sum of |origin| +
// |centre| + |camera| over the axes, the largest at a corner), taken 4
// times over. Also SKIP: every corner behind by more than that margin.
__device__ __forceinline__ unsigned td_cull_mask(const float* p, int ci, int cj, int nzc,
                                                 int lane) {
  const double eps = 1.0 / 16777216.0;
  const double fx = p[12], fy = p[13], cx = p[14], cy = p[15];
  const double img_w = p[22], img_h = p[23];
  // the four sides' z coefficients (the per-voxel tests need them > 0)
  const double kz[4] = {1.001 * (cx + 1.0), 1.001 * (img_w - cx), 1.001 * (cy + 1.0),
                        1.001 * (img_h - cy)};
  const bool sides = fx > 0.0 && fy > 0.0 && kz[0] > 0.0 && kz[1] > 0.0 && kz[2] > 0.0 &&
                     kz[3] > 0.0;
  unsigned mask = 0;
  for (int q0 = 0; q0 < 8 * nzc; q0 += 32) {
    const int q = q0 + lane, ck = q >> 3, corner = q & 7;
    const int idx[3] = {ci * 8 + ((corner & 1) ? 7 : 0), cj * 8 + ((corner & 2) ? 7 : 0),
                        ck * 128 + ((corner & 4) ? 127 : 0)};
    double cam[3] = {0.0, 0.0, 0.0}, m = 0.0;
    for (int a = 0; a < 3; ++a) {
      const double pos = (double)p[18 + a] + ((double)idx[a] + 0.5) * (double)p[17];
      const double d = pos - (double)p[9 + a];
      m += fabs((double)p[18 + a]) + fabs(pos) + fabs((double)p[9 + a]);
      for (int r = 0; r < 3; ++r) cam[r] += d * (double)p[3 * r + a];
    }
    double side[4] = {fx * cam[0] + kz[0] * cam[2], -fx * cam[0] + kz[1] * cam[2],
                      fy * cam[1] + kz[2] * cam[2], -fy * cam[1] + kz[3] * cam[2]};
    double zmax = cam[2], mmax = m;
    for (int o = 1; o < 8; o <<= 1) {
      zmax = fmax(zmax, __shfl_xor_sync(HS_FULL_MASK, zmax, o));
      mmax = fmax(mmax, __shfl_xor_sync(HS_FULL_MASK, mmax, o));
      for (int k = 0; k < 4; ++k) side[k] = fmax(side[k], __shfl_xor_sync(HS_FULL_MASK, side[k], o));
    }
    bool cull = zmax < -36.0 * eps * mmax - 1e-5;
    if (sides) {
      const double f = fmax(fx, fy);
      for (int k = 0; k < 4; ++k)
        cull = cull || side[k] < -4.0 * (9.0 * f + 10.1 * kz[k]) * eps * mmax - 1e-9;
    }
    const unsigned bits = __ballot_sync(HS_FULL_MASK, cull && corner == 0 && ck < nzc);
    for (int c = 0; c < 4; ++c)
      if (bits & (1u << (8 * c))) mask |= 1u << ((q0 >> 3) + c);
  }
  return mask;
}

// Whether sub-block s of the staged chunk at ``off`` has an observed voxel
// (weight > 0): warp-uniform. Without one every moment term is zero.
__device__ __forceinline__ bool td_observed(const float* s, int off, int sb, int lane) {
  const float* w = s + off + TD_PLANE + 8 * sb;
  bool any = false;
#pragma unroll
  for (int r = lane; r < 64; r += 32) {
    const float4 a = *reinterpret_cast<const float4*>(w + r * TD_ROW);
    const float4 b = *reinterpret_cast<const float4*>(w + r * TD_ROW + 4);
    any = any || a.x > 0.0f || a.y > 0.0f || a.z > 0.0f || a.w > 0.0f || b.x > 0.0f ||
          b.y > 0.0f || b.z > 0.0f || b.w > 0.0f;
  }
  return __any_sync(HS_FULL_MASK, any);
}

// Warp s: the moments of sub-block s of the chunk at ``a`` (its +z halo at
// ``b``) into s_mom[s] by lane 0; an unobserved sub-block only marks its
// counts (fields 10 and 11) zero.
__device__ __forceinline__ void td_moments(const float* s, int a, int b, int z_lim, int warp,
                                           int lane, float (*mom)[HS_NMOM + 1]) {
  if (!td_observed(s, a, warp, lane)) {
    if (lane == 0) mom[warp][10] = mom[warp][11] = 0.0f;
    return;
  }
  double acc[HS_NMOM];
  hs_subblock_moments_warp(TdHaloChunk{s, a, b}, warp, lane, z_lim, acc);
  if (lane == 0)
    for (int k = 0; k < HS_NMOM; ++k) mom[warp][k] = (float)acc[k];
}

__global__ void __launch_bounds__(TD_THREADS, 1)
tsdf_dense_kernel(float* __restrict__ vol, int nx, int ny, int nz, TdMips mips,
                  const float* __restrict__ params, int* __restrict__ cls,
                  float* __restrict__ planes, int* __restrict__ next_col) {
  extern __shared__ __align__(128) float s_buf[];  // TD_NBUF staged chunks
  __shared__ __align__(8) uint64_t s_bar[TD_NBUF];
  __shared__ float s_red[7][TD_WARPS];
  __shared__ float s_bb[8];  // umin, umax, vmin, vmax, zmin, zmax, any view
  __shared__ int s_win[4];   // class, level, v0, u0
  __shared__ int s_col[4];   // the block's k-th column at k % 4 (n_cols: none)
  __shared__ float s_mom[TD_NBUF][HS_NSUB][HS_NMOM + 1];
  __shared__ float s_zero[HS_NMOM];  // all-zero moments
  __shared__ HsPlaneShape s_empty;   // their shape (an unobserved sub-block's)
  __shared__ float p[TD_NPARAM];     // the params, read from here (L2 holds little else)

  const int nbx = nx / 8, nby = ny / 8, nzc = nz / 128;
  const int n_cols = nbx * nby;
  const size_t plane = (size_t)nx * ny * nz;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int z = tid & 127, wq = tid >> 7;  // thread's z; its rows iy = wq and wq + 4
  // the block's items: chunk t % nzc of its (t / nzc)-th column; block b
  // starts on column b and takes each next one from the counter (columns
  // differ in work: the ones in view are integrated), claimed by thread 0
  // when the column's first chunk is staged, two items ahead
  auto claim = [&]() { return min(atomicAdd(next_col, 1) + (int)gridDim.x, n_cols); };

  if (tid == 0) {
    for (int b = 0; b < TD_NBUF; ++b) hs_mbar_init(&s_bar[b], 1);
    s_col[0] = blockIdx.x;
    if (nzc == 1) s_col[1] = claim();
  }
  if (tid < HS_NMOM) s_zero[tid] = 0.0f;
  if (tid < TD_NPARAM) p[tid] = params[tid];
  __syncthreads();
  if (tid == 0) s_empty = hs_plane_shape(s_zero);
  const float trunc = p[16], max_weight = p[21];
  const float img_w = p[22], img_h = p[23];
  for (int t = 0; t < 2; ++t) {
    const int c = s_col[(t / nzc) & 3];
    if (c < n_cols)
      td_stage(vol, plane, c / nby, c % nby, t % nzc, ny, nz, s_buf, t * TD_BUF, &s_bar[t], tid);
  }

  unsigned cull = 0;
  for (int t = 0;; ++t) {
    const int c = s_col[(t / nzc) & 3];
    if (c >= n_cols) break;
    const int ci = c / nby, cj = c % nby, ck = t % nzc;
    const int buf = t % TD_NBUF;
    const int chunk = (ci * nby + cj) * nzc + ck;
    if (ck == 0) {
      cull = td_cull_mask(p, ci, cj, nzc, lane);
      // lanes past R / 8 of the column's planes tile are zeros
      for (int i = tid; i < HS_N_FIELDS * (128 - 16 * nzc); i += TD_THREADS) {
        const int f = i / (128 - 16 * nzc), l = 16 * nzc + i % (128 - 16 * nzc);
        planes[((size_t)c * HS_N_FIELDS + f) * 128 + l] = 0.0f;
      }
    }

    // 1. classify; the thread's voxels k = 2 ix + h are (ix, iy = wq + 4 h, z)
    float uf[16], vf[16], zc[16];
    unsigned iv = 0;
    int cl = TD_SKIP, lvl = 3, v0 = 0, u0 = 0;
    if (!((cull >> ck) & 1u)) {
      const HsAxisTerms cz = hs_voxel_axis(p, 2, ck * 128, z);
      HsAxisTerms by[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) by[h] = hs_voxel_axis(p, 1, cj * 8, wq + 4 * h);
      const float fx = p[12], fy = p[13], cx = p[14], cy = p[15];
      float umin = TD_BIG, umax = -TD_BIG, vmin = TD_BIG, vmax = -TD_BIG, zmin = TD_BIG,
            zmax = -TD_BIG;
#pragma unroll
      for (int ix = 0; ix < 8; ++ix) {
        const HsAxisTerms ax = hs_voxel_axis(p, 0, ci * 8, ix);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int k = 2 * ix + h;
          const float xc = ax.c0 + by[h].c0 + cz.c0, yc = ax.c1 + by[h].c1 + cz.c1,
                      zz = ax.c2 + by[h].c2 + cz.c2;
          const float safe_z = hs_clamp_min(zz, 1e-6f);
          const float u = fx * xc / safe_z + cx, v = fy * yc / safe_z + cy;
          uf[k] = u;
          vf[k] = v;
          zc[k] = zz;
          if ((zz > 1e-6f) && (u >= 0.0f) && (u <= img_w - 1.0f) && (v >= 0.0f) &&
              (v <= img_h - 1.0f)) {
            iv |= 1u << k;
            umin = fminf(umin, u);
            umax = fmaxf(umax, u);
            vmin = fminf(vmin, v);
            vmax = fmaxf(vmax, v);
            zmin = fminf(zmin, zz);
            zmax = fmaxf(zmax, zz);
          }
        }
      }
      // the six extrema and any-in-view over the block (exact in any order)
      const bool any_w = __any_sync(HS_FULL_MASK, iv != 0);
      umin = hs_warp_min(umin);
      umax = hs_warp_max(umax);
      vmin = hs_warp_min(vmin);
      vmax = hs_warp_max(vmax);
      zmin = hs_warp_min(zmin);
      zmax = hs_warp_max(zmax);
      if (lane == 0) {
        s_red[0][warp] = umin;
        s_red[1][warp] = umax;
        s_red[2][warp] = vmin;
        s_red[3][warp] = vmax;
        s_red[4][warp] = zmin;
        s_red[5][warp] = zmax;
        s_red[6][warp] = any_w ? 1.0f : 0.0f;
      }
      __syncthreads();
      if (warp == 0) {
        const bool ok = lane < TD_WARPS;
        const float r0 = hs_warp_min(ok ? s_red[0][lane] : TD_BIG);
        const float r1 = hs_warp_max(ok ? s_red[1][lane] : -TD_BIG);
        const float r2 = hs_warp_min(ok ? s_red[2][lane] : TD_BIG);
        const float r3 = hs_warp_max(ok ? s_red[3][lane] : -TD_BIG);
        const float r4 = hs_warp_min(ok ? s_red[4][lane] : TD_BIG);
        const float r5 = hs_warp_max(ok ? s_red[5][lane] : -TD_BIG);
        const float r6 = hs_warp_max(ok ? s_red[6][lane] : 0.0f);
        if (lane == 0) {
          s_bb[0] = r0;
          s_bb[1] = r1;
          s_bb[2] = r2;
          s_bb[3] = r3;
          s_bb[4] = r4;
          s_bb[5] = r5;
          s_bb[6] = r6;
        }
      }
      __syncthreads();
      if (s_bb[6] > 0.5f) {
        umin = s_bb[0];
        umax = s_bb[1];
        vmin = s_bb[2];
        vmax = s_bb[3];
        zmin = s_bb[4];
        zmax = s_bb[5];
        // the L3 rectangle over the footprint
        const int r0 = min(max((int)(vmin / 8.0f) - 1, 0), TD_L3_V - TD_RECT_V) & ~7;
        float dmin = TD_BIG, dmax = -TD_BIG;
        bool allv = true;
        // every load first (the maps are small and in range), then the tests
        constexpr int kRect = TD_RECT_V * TD_L3_U / TD_THREADS;
        float mn[kRect], mx[kRect], va[kRect];
#pragma unroll
        for (int j = 0; j < kRect; ++j) {
          const int a = r0 * TD_L3_U + tid + j * TD_THREADS;
          mn[j] = __ldg(&mips.l3min[a]);
          mx[j] = __ldg(&mips.l3max[a]);
          va[j] = __ldg(&mips.l3valid[a]);
        }
#pragma unroll
        for (int j = 0; j < kRect; ++j) {
          const int i = tid + j * TD_THREADS;
          const int r = i / TD_L3_U, col = i % TD_L3_U;
          const float rowf = (float)r + (float)r0, colf = (float)col;
          const bool in_rect = (colf >= umin / 8.0f - 1.0f) && (colf <= umax / 8.0f + 1.0f) &&
                               (rowf >= vmin / 8.0f - 1.0f) && (rowf <= vmax / 8.0f + 1.0f);
          if (in_rect) {
            dmin = fminf(dmin, mn[j]);
            dmax = fmaxf(dmax, mx[j]);
            allv = allv && va[j] > 0.5f;
          }
        }
        const bool allv_w = __all_sync(HS_FULL_MASK, allv);
        dmin = hs_warp_min(dmin);
        dmax = hs_warp_max(dmax);
        if (lane == 0) {
          s_red[0][warp] = dmin;
          s_red[1][warp] = dmax;
          s_red[2][warp] = allv_w ? 1.0f : 0.0f;
        }
        __syncthreads();
        if (warp == 0) {
          const bool ok = lane < TD_WARPS;
          const float dmn = hs_warp_min(ok ? s_red[0][lane] : TD_BIG);
          const float dmx = hs_warp_max(ok ? s_red[1][lane] : -TD_BIG);
          const float alv = hs_warp_min(ok ? s_red[2][lane] : 1.0f);
          if (lane == 0) {
            const bool all_valid = alv > 0.5f;
            const bool bbox_fits = (umax - umin) <= 120.0f && (vmax - vmin) <= 120.0f;
            const bool behind = bbox_fits && (zmin - trunc > dmx);
            const bool is_free = bbox_fits && (zmax + trunc < dmn) && (dmx > 0.0f) && all_valid;
            const int k_cl = is_free ? TD_FREE : (behind ? TD_SKIP : TD_BAND);
            int k_lvl = 3;
            const float span_u = umax - umin, span_v = vmax - vmin;
            for (int l = 2; l >= 0; --l) {
              const float sl = (float)(1 << l);
              if (span_v <= 22.0f * sl && span_u <= 60.0f * sl) k_lvl = l;
            }
            int k_v0 = 0, k_u0 = 0;
            if (k_lvl < 3) {
              const float sc = (float)(1 << k_lvl);
              const int mh = k_lvl == 0 ? mips.h[0] : (k_lvl == 1 ? mips.h[1] : mips.h[2]);
              const int mw = k_lvl == 0 ? mips.w[0] : (k_lvl == 1 ? mips.w[1] : mips.w[2]);
              k_v0 = min(max(((int)(vmin / sc) - 1) & ~7, 0), mh - TD_WIN_V);
              k_u0 = min(max(((int)(umin / sc) - 1) & ~127, 0), mw - TD_WIN_U);
            }
            s_win[0] = k_cl;
            s_win[1] = k_lvl;
            s_win[2] = k_v0;
            s_win[3] = k_u0;
          }
        }
        __syncthreads();
        cl = s_win[0];
        lvl = s_win[1];
        v0 = s_win[2];
        u0 = s_win[3];
      }
    }
    if (tid == 0) cls[chunk] = cl;

    // 2. the chunk's bytes
    hs_mbar_wait(&s_bar[buf], (t / TD_NBUF) & 1);

    // 3. read-modify-write of a visited chunk, in the staged copy; a cell
    // goes back to the volume only where it changes
    if (cl != TD_SKIP) {
      float* st = s_buf + buf * TD_BUF;
      const uint64_t pol = td_evict_first();
      // x / 2^l is x * 2^-l exactly: the window scale multiplies
      const float inv_scale = 1.0f / (float)(1 << lvl);
      // the level's mip by static selection (a by-value array indexed at run
      // time would be copied to local memory)
      const float* mip =
          lvl == 0 ? mips.m[0] : (lvl == 1 ? mips.m[1] : (lvl == 2 ? mips.m[2] : mips.m[3]));
      const int mw =
          lvl == 0 ? mips.w[0] : (lvl == 1 ? mips.w[1] : (lvl == 2 ? mips.w[2] : mips.w[3]));
      const int nrows = lvl < 3 ? TD_WIN_V : mips.h[3];
      const float v0f = (float)v0, u0f = (float)u0;
      // BAND: the bilinear depth of every voxel in view first (mip loads
      // only, so they overlap), then the cells; a voxel out of view is
      // not updated whatever its depth
      float dk[16];
      unsigned has_m = 0;
      if (cl == TD_BAND) {
#pragma unroll
        for (int k = 0; k < 16; ++k) {
          dk[k] = 0.0f;
          if (!((iv >> k) & 1u)) continue;
          const float uw = uf[k] * inv_scale - u0f;
          const float vw = vf[k] * inv_scale - v0f;
          const bool supp = (uw >= 0.0f) && (uw <= (float)(TD_WIN_U - 1)) && (vw >= 0.0f) &&
                            (vw <= (float)(nrows - 1));
          float den = 0.0f;
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
            dk[k] = num / hs_clamp_min(den, 1e-12f);
          }
          if (supp && den > 1e-6f) has_m |= 1u << k;
        }
      }
#pragma unroll
      for (int k = 0; k < 16; ++k) {
        const int ix = k >> 1, iy = wq + 4 * (k & 1);
        const float d = cl == TD_BAND ? dk[k] : TD_BIG;
        const bool has = cl == TD_BAND ? ((has_m >> k) & 1u) != 0 : true;
        const int o = (ix * 8 + iy) * TD_ROW + z;
        const float told = st[o], wold = st[TD_PLANE + o];
        const float sdf = d - zc[k];
        const bool update = ((iv >> k) & 1u) && has && (sdf >= -trunc);
        const float wadd = update ? 1.0f : 0.0f;
        const float wnew = fminf(wold + wadd, max_weight);
        float tnew = told;
        if (update) {
          const float sample = hs_clamp_max(hs_clamp_min(sdf / trunc, -1.0f), 1.0f);
          const float denom = hs_clamp_min(wold + wadd, 1.0f);
          tnew = (told * wold + sample * wadd) / denom;
        }
        if (update || wnew != wold) {
          st[o] = tnew;
          st[TD_PLANE + o] = wnew;
          const size_t a =
              ((size_t)(ci * 8 + ix) * ny + (cj * 8 + iy)) * nz + (size_t)ck * 128 + z;
          td_store(vol + a, tnew, pol);
          td_store(vol + plane + a, wnew, pol);
        }
      }
      __syncthreads();  // the halo slice and the chunk as fitted
    }

    // 4. fits: chunk ck - 1 with its halo, and chunk ck if it ends the column
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
    const bool fit_prev = ck > 0, fit_this = ck == nzc - 1;
    if (tid == 0 && (t + 2) % nzc == 0) s_col[((t + 2) / nzc) & 3] = claim();
    if (fit_prev)
      td_moments(s_buf, ((t - 1) % TD_NBUF) * TD_BUF, buf * TD_BUF, 128, warp, lane,
                 s_mom[(t - 1) % TD_NBUF]);
    if (fit_this)
      td_moments(s_buf, buf * TD_BUF, buf * TD_BUF, 127, warp, lane, s_mom[buf]);
    __syncthreads();  // moments in s_mom; buffer (t - 1) % 3 is free; s_col

    // 5. stage item t + 2 into the free buffer
    const int c2 = s_col[((t + 2) / nzc) & 3];
    if (c2 < n_cols) {
      const int b2 = (t + 2) % TD_NBUF;
      td_stage(vol, plane, c2 / nby, c2 % nby, (t + 2) % nzc, ny, nz, s_buf, b2 * TD_BUF,
               &s_bar[b2], tid);
    }
    // the eigen analyses: 16 lanes of one warp a fitted chunk, the tile
    // written coalesced (s_mom slot u % 3 is next written for item u + 3,
    // after at least one more barrier)
    for (int j = 0; j < 2; ++j) {
      const int u = t - 1 + j;
      if (!(j == 0 ? fit_prev : fit_this)) continue;
      if (warp != (u % TD_WARPS) || lane >= HS_NSUB) continue;
      const int cku = ck - 1 + j;
      const float* m = s_mom[u % TD_NBUF][lane];
      float f[HS_N_FIELDS];
      hs_plane_emit(m[10] == 0.0f && m[11] == 0.0f ? s_empty : hs_plane_shape(m), g,
                    (float)(cku * HS_NSUB + lane), f);
      float* dst = planes + (size_t)c * HS_N_FIELDS * 128 + cku * HS_NSUB + lane;
#pragma unroll
      for (int k = 0; k < HS_N_FIELDS; ++k) dst[(size_t)k * 128] = f[k];
    }
  }
}

// vol: the (2, nx, ny, nz) float32 array, updated in place; cls: (nx / 8)
// (ny / 8) (nz / 128) chunk classes; planes: the (nx / 8, ny / 8, 16, 128)
// output, every lane written (zeros past nz / 8); next_col: one int of
// scratch (the column counter, zeroed here); grid: the persistent grid (at
// most the resident blocks an SM times the SMs).
extern "C" int hs_tsdf_dense(float* vol, int nx, int ny, int nz, const float* mip0, int h0,
                             int w0, const float* mip1, int h1, int w1, const float* mip2, int h2,
                             int w2, const float* l3, int h3, int w3, const float* l3min,
                             const float* l3max, const float* l3valid, const float* params,
                             int* cls, float* planes, int* next_col, int grid,
                             void* stream) {
  if (nz % 128 || nz / 128 > TD_MAX_NZC || nx % 8 || ny % 8) return (int)cudaErrorInvalidValue;
  if (grid <= 0 || nx <= 0 || ny <= 0 || nz <= 0) return 0;
  TdMips mips;
  mips.m[0] = mip0; mips.h[0] = h0; mips.w[0] = w0;
  mips.m[1] = mip1; mips.h[1] = h1; mips.w[1] = w1;
  mips.m[2] = mip2; mips.h[2] = h2; mips.w[2] = w2;
  mips.m[3] = l3; mips.h[3] = h3; mips.w[3] = w3;
  mips.l3min = l3min;
  mips.l3max = l3max;
  mips.l3valid = l3valid;
  cudaError_t e = cudaFuncSetAttribute(tsdf_dense_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, TD_SMEM);
  if (e != cudaSuccess) return (int)e;
  const cudaStream_t s = (cudaStream_t)stream;
  e = cudaMemsetAsync(next_col, 0, sizeof(int), s);
  if (e != cudaSuccess) return (int)e;
  tsdf_dense_kernel<<<grid, TD_THREADS, TD_SMEM, s>>>(vol, nx, ny, nz, mips, params, cls, planes,
                                                       next_col);
  return (int)cudaGetLastError();
}

// Resident blocks an SM: out[0] the kernel.
extern "C" int hs_tsdf_dense_occupancy(int, int* out) {
  return hs_occupancy(tsdf_dense_kernel, TD_THREADS, TD_SMEM, out);
}
