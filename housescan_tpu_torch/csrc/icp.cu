// K3: every Gauss-Newton iteration of one ICP pyramid level in ONE
// cooperative, persistent launch (replaces housescan_tpu/ops/icp_pallas.py
// _kernel, line 51, via icp_level_pallas). See
// housescan_tpu_torch/ops/icp_cuda.py for the plain version and the plan.
//
// Bound: bytes. The level's packed (19, hp, wp) float32 maps must be read
// once: 23.3 MB at level 0 (640 x 480), 7 us at 3.35 TB/s; the arithmetic
// (~120 float operations a pixel and iteration) is below that. The
// two-launch form this replaces read the maps again every iteration and
// summed the block partials serially in one block.
//
// Design. At most one block per SM (the grid is the wrapper's plan: the
// SM count, or fewer at a small level, where every block still takes at
// least 1024 pixels; launched with cudaLaunchCooperativeKernel). Block b
// owns the contiguous slice [b ppb, (b + 1) ppb) of the level's pixels and
// copies the 19 rows of its first sppb pixels into shared memory once
// (sppb x 76 B: 177 KB at level 0 of 640 x 480 on 132 SMs, where sppb =
// ppb and every iteration reads shared memory only). A slice larger than
// a block's shared memory (above 392,832 pixels a level on 132 SMs, e.g.
// 1280 x 720) reads the rest of its pixels from global memory every
// iteration, where they stay in L2. An iteration:
//   1. each thread sums the 30 terms (21 A-upper, 6 b, sq, n_corr,
//      visible-model count) of its pixels t, t + 512, ... in order; a
//      fixed xor tree within warps and the warps in order give the block's
//      30 sums, written to partials[it & 1][30][block] (double-buffered by
//      parity: a fast block's next write never lands where a slow block
//      still reads);
//   2. one grid sync;
//   3. EVERY block sums all blocks' partials in double, one warp per sum
//      (lanes over blocks, then a fixed xor tree), and its thread 0 runs
//      the gate state machine and hs_solve_twist (solve6.cuh). Identical
//      inputs in an identical order give every block the same pose bit for
//      bit, so no second grid sync is needed.
// Convergence and the widen_until gate are decided from those identical
// sums, so every block leaves the loop at the same iteration: a block that
// decided alone would leave the others waiting at the grid sync forever.
// Block 0 alone writes the 32-float state at the end. No float atomics:
// the card repeats itself bit for bit.
//
// The parameter row (ops/icp_cuda._params) comes by value with its host
// entries; the previous pose (entries 0-11) and a gate given as a device
// scalar (entries 17, 24, squared here) are read on the device, so the
// wrapper launches nothing but this kernel.
//
// state[32]: 0-15 pose, 16 rmse, 17 n_corr, 18 iterations run,
// 19 converged, 20 visible-model pixels, 21 widen_until, 22 n_corr as
// int32 bits; the partials follow it.
#include <cooperative_groups.h>

#include "common.cuh"
#include "solve6.cuh"

namespace cg = cooperative_groups;

#define ICP_THREADS 512
#define ICP_WARPS (ICP_THREADS / 32)
#define ICP_NP 30    // sums a block contributes per iteration
#define ICP_ROWS 19  // rows of the packed maps
#define ICP_LOADS 5  // partials a lane loads at once (160 blocks a pass)

enum {
  ST_RMSE = 16, ST_CORR = 17, ST_ITERS = 18, ST_CONV = 19, ST_MOK = 20, ST_WIDEN = 21,
  ST_CORR_I = 22, ST_LEN = 32,
};

struct IcpParams {
  float v[32];
};

// The 30 terms of pixel (py, px), whose 19 map values lie at
// q[r * stride], added into v (the association math of the reference
// kernel). A pixel that cannot correspond (no live point or normal, no
// model point, outside the image) has weight 0, so its 28 weighted terms
// are zeros, which add nothing: only its visible-model count is added.
__device__ __forceinline__ void icp_pixel(float* v, const float* q, int stride, float py,
                                          float px, const float* st, const float* p,
                                          float dist2) {
  const float r00 = st[0], r01 = st[1], r02 = st[2];
  const float r10 = st[4], r11 = st[5], r12 = st[6];
  const float r20 = st[8], r21 = st[9], r22 = st[10];
  const float tx = st[12], ty = st[13], tz = st[14];
  const float pr00 = p[0], pr01 = p[1], pr02 = p[2];
  const float pr10 = p[3], pr11 = p[4], pr12 = p[5];
  const float pr20 = p[6], pr21 = p[7], pr22 = p[8];
  const float ptx = p[9], pty = p[10], ptz = p[11];
  const float fx = p[12], fy = p[13], cx = p[14], cy = p[15];
  const float gate = p[16], sin2 = p[18], huber = p[19];
  const float h_valid = p[22], w_valid = p[23];

  const float mok = q[12 * stride];
  const bool in_img = (py < h_valid) && (px < w_valid);
  v[29] += (mok > 0.5f && in_img) ? 1.0f : 0.0f;
  const float lvz = q[2 * stride];
  const float lnx = q[3 * stride], lny = q[4 * stride], lnz = q[5 * stride];
  const bool live_ok = (lvz > 0.0f) && (lnx * lnx + lny * lny + lnz * lnz > 0.25f);
  if (!(live_ok && mok > 0.5f && in_img)) return;
  const float lvx = q[0], lvy = q[stride];
  const float mvx = q[6 * stride], mvy = q[7 * stride], mvz = q[8 * stride];
  const float mnx = q[9 * stride], mny = q[10 * stride], mnz = q[11 * stride];
  const float gux = q[13 * stride], guy = q[14 * stride], guz = q[15 * stride];
  const float gvx = q[16 * stride], gvy = q[17 * stride], gvz = q[18 * stride];

  const float vwx = lvx * r00 + lvy * r10 + lvz * r20 + tx;
  const float vwy = lvx * r01 + lvy * r11 + lvz * r21 + ty;
  const float vwz = lvx * r02 + lvy * r12 + lvz * r22 + tz;
  const float nwx = lnx * r00 + lny * r10 + lnz * r20;
  const float nwy = lnx * r01 + lny * r11 + lnz * r21;
  const float nwz = lnx * r02 + lny * r12 + lnz * r22;

  const float dxw = vwx - ptx, dyw = vwy - pty, dzw = vwz - ptz;
  const float xc = dxw * pr00 + dyw * pr01 + dzw * pr02;
  const float yc = dxw * pr10 + dyw * pr11 + dzw * pr12;
  const float zc = dxw * pr20 + dyw * pr21 + dzw * pr22;
  const float safe_z = zc > 1e-6f ? zc : 1.0f;
  const float u = fx * xc / safe_z + cx;
  const float vv = fy * yc / safe_z + cy;
  const bool inb = (zc > 1e-6f) && (u >= 0.0f) && (u <= w_valid - 1.0f) && (vv >= 0.0f) &&
                   (vv <= h_valid - 1.0f);
  const float du = u - px, dv = vv - py;
  const bool near = (fabsf(du) <= gate) && (fabsf(dv) <= gate);
  const bool m_ok = (mok > 0.5f) && near;

  const float amx = mvx + gux * du + gvx * dv;
  const float amy = mvy + guy * du + gvy * dv;
  const float amz = mvz + guz * du + gvz * dv;
  const float ddx = vwx - amx, ddy = vwy - amy, ddz = vwz - amz;
  const bool dist_ok = ddx * ddx + ddy * ddy + ddz * ddz < dist2;
  const float cxn = nwy * mnz - nwz * mny;
  const float cyn = nwz * mnx - nwx * mnz;
  const float czn = nwx * mny - nwy * mnx;
  const bool angle_ok = cxn * cxn + cyn * cyn + czn * czn < sin2;
  const bool corr = live_ok && inb && m_ok && dist_ok && angle_ok && in_img;

  const float g0 = vwy * mnz - vwz * mny;
  const float g1 = vwz * mnx - vwx * mnz;
  const float g2 = vwx * mny - vwy * mnx;
  const float r_ = mnx * -ddx + mny * -ddy + mnz * -ddz;
  const float w_rob = hs_clamp_max(huber / hs_clamp_min(fabsf(r_), 1e-9f), 1.0f);
  const float rx = amx - ptx, ry = amy - pty, rz = amz - ptz;
  const float rn = sqrtf(hs_clamp_min(rx * rx + ry * ry + rz * rz, 1e-18f));
  const float incidence = hs_clamp_min(-(mnx * rx + mny * ry + mnz * rz) / rn, 0.0f);
  const float w = (corr ? 1.0f : 0.0f) * w_rob * incidence * incidence;

  const float wg[6] = {w * g0, w * g1, w * g2, w * mnx, w * mny, w * mnz};
  const float wr = w * r_;
  int k = 0;
#pragma unroll
  for (int i = 0; i < 6; ++i)
#pragma unroll
    for (int j = i; j < 6; ++j) v[k++] += wg[i] * wg[j];
#pragma unroll
  for (int i = 0; i < 6; ++i) v[21 + i] += wg[i] * wr;
  v[27] += wr * wr;
  v[28] += corr ? 1.0f : 0.0f;
}

// The gate state machine and the solve of iteration ``it`` from the grid's
// 30 sums ``acc``, updating the block's copy of the state.
__device__ void icp_update(const float* acc, const float* p, float* st, int it, int n_iters) {
  if (it == 0) st[ST_MOK] = acc[29];
  const float mok_total = st[ST_MOK];
  float a_flat[36];
  int k = 0;
  for (int i = 0; i < 6; ++i)
    for (int j = i; j < 6; ++j) {
      a_flat[i * 6 + j] = acc[k];
      a_flat[j * 6 + i] = acc[k];
      ++k;
    }
  float pose[16], res[17];
  for (int i = 0; i < 16; ++i) pose[i] = st[i];
  hs_solve_twist(a_flat, acc + 21, pose, p[20], p[21], res);

  const float norm = res[16];
  const float n_corr = acc[28];
  const float rmse = sqrtf(acc[27] / hs_clamp_min(n_corr, 1.0f));
  const bool healthy = n_corr >= p[25] * mok_total;
  const int widen = (int)st[ST_WIDEN];
  const bool was_tight = it >= widen;
  const bool trigger = !healthy && was_tight;
  for (int i = 0; i < 16; ++i) st[i] = res[i];
  st[ST_RMSE] = rmse;
  st[ST_CORR] = n_corr;
  st[ST_CORR_I] = __int_as_float((int)n_corr);
  st[ST_ITERS] = st[ST_ITERS] + 1.0f;
  st[ST_WIDEN] = (float)(trigger ? it + 1 + (n_iters - it) / 2 : widen);
  st[ST_CONV] = (norm <= 1e-5f && healthy && was_tight) ? 1.0f : 0.0f;
}

__global__ void __launch_bounds__(ICP_THREADS, 1)
icp_level_kernel(const float* __restrict__ m, int hp, int wp, int ppb, int sppb,
                 IcpParams prm, const float* __restrict__ prev_pose,
                 const float* __restrict__ dist_gate, const float* __restrict__ tight_gate,
                 const float* __restrict__ pose0, float* state, int n_iters) {
  extern __shared__ float4 s_maps4[];  // [ICP_ROWS][sppb] floats
  float* s_maps = reinterpret_cast<float*>(s_maps4);
  __shared__ float s_warp[ICP_WARPS][ICP_NP];
  __shared__ float s_acc[ICP_NP];
  __shared__ float s_st[32];
  __shared__ float s_p[32];
  cg::grid_group grid = cg::this_grid();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n = hp * wp;
  const int base = blockIdx.x * ppb;
  const int cnt = min(ppb, n - base);  // a multiple of 4 (the plan's ppb and wp are)
  const int held = min(cnt, sppb);     // the slice's pixels held in shared memory

  // the held pixels' rows, once: 16-byte loads, all in flight together
  const int q4 = held >> 2;
  for (int j = tid; j < ICP_ROWS * q4; j += ICP_THREADS) {
    const int r = j / q4, i = j - r * q4;
    s_maps4[r * (sppb >> 2) + i] = __ldg(reinterpret_cast<const float4*>(m + (size_t)r * n + base) + i);
  }
  if (tid < 32) {
    s_st[tid] = tid < 16 ? pose0[tid] : 0.0f;
    float v = prm.v[tid];
    if (tid < 12) v = prev_pose[tid < 9 ? (tid / 3) * 4 + tid % 3 : tid + 3];
    if (tid == 17 && dist_gate) v = dist_gate[0] * dist_gate[0];
    if (tid == 24 && tight_gate) v = tight_gate[0] * tight_gate[0];
    s_p[tid] = v;
  }
  __syncthreads();
  float* partials = state + ST_LEN;

  for (int it = 0; it < n_iters; ++it) {
    // 1. the block's 30 sums over its slice, in a fixed order
    const float dist2 = (it < (int)s_st[ST_WIDEN]) ? s_p[17] : s_p[24];
    float v[ICP_NP];
#pragma unroll
    for (int k = 0; k < ICP_NP; ++k) v[k] = 0.0f;
    int py = (base + tid) / wp, px = (base + tid) % wp;
    int i = tid;
    for (; i < held; i += ICP_THREADS) {
      icp_pixel(v, s_maps + i, sppb, (float)py, (float)px, s_st, s_p, dist2);
      for (px += ICP_THREADS; px >= wp; px -= wp) ++py;
    }
    for (; i < cnt; i += ICP_THREADS) {  // the pixels past shared memory, if any
      icp_pixel(v, m + base + i, n, (float)py, (float)px, s_st, s_p, dist2);
      for (px += ICP_THREADS; px >= wp; px -= wp) ++py;
    }
#pragma unroll
    for (int k = 0; k < ICP_NP; ++k) {
      float s = v[k];
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) s = s + __shfl_xor_sync(HS_FULL_MASK, s, o);
      if (lane == 0) s_warp[warp][k] = s;
    }
    __syncthreads();
    float* part = partials + (size_t)(it & 1) * gridDim.x * ICP_NP;  // [ICP_NP][blocks]
    if (tid < ICP_NP) {
      float s = s_warp[0][tid];
      for (int w8 = 1; w8 < ICP_WARPS; ++w8) s = s + s_warp[w8][tid];
      part[(size_t)tid * gridDim.x + blockIdx.x] = s;
    }

    // 2. every block's sums are written
    grid.sync();

    // 3. every block: the grid's sums in double (warp w takes sums w and
    // w + 16; lane l the blocks l, l + 32, ..., loaded before they are
    // added, in that order, a warp's loads coalesced; a missing block adds
    // an exact 0), then the gate and the solve, all identical from block
    // to block
    {
      const int k1 = warp + ICP_WARPS;
      const bool two = k1 < ICP_NP;
      double s0 = 0.0, s1 = 0.0;
      for (int b0 = 0; b0 < (int)gridDim.x; b0 += 32 * ICP_LOADS) {
        float x0[ICP_LOADS], x1[ICP_LOADS];
#pragma unroll
        for (int j = 0; j < ICP_LOADS; ++j) {
          const int b = b0 + lane + 32 * j;
          const bool in = b < (int)gridDim.x;
          x0[j] = in ? __ldcg(part + (size_t)warp * gridDim.x + b) : 0.0f;
          x1[j] = (in && two) ? __ldcg(part + (size_t)k1 * gridDim.x + b) : 0.0f;
        }
#pragma unroll
        for (int j = 0; j < ICP_LOADS; ++j) {
          s0 += (double)x0[j];
          s1 += (double)x1[j];
        }
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        s0 += __shfl_xor_sync(HS_FULL_MASK, s0, o);
        s1 += __shfl_xor_sync(HS_FULL_MASK, s1, o);
      }
      if (lane == 0) {
        s_acc[warp] = (float)s0;
        if (two) s_acc[k1] = (float)s1;
      }
    }
    __syncthreads();
    if (tid == 0) icp_update(s_acc, s_p, s_st, it, n_iters);
    __syncthreads();
    if (s_st[ST_CONV] > 0.5f) break;  // the same decision in every block
  }
  if (blockIdx.x == 0 && tid < ST_LEN) state[tid] = s_st[tid];
}

// SM count and the shared memory a block may opt into: out[0], out[1].
extern "C" int hs_device_limits(int* out) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(out, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(out + 1, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return (int)e;
}

// packed: the (19, hp, wp) maps; ppb: pixels a block, sppb: of them held in
// shared memory (icp_cuda.icp_plan: multiples of 32, sppb <= ppb); params:
// the 32-float row on the host; prev_pose: the (4, 4) previous pose;
// dist_gate, tight_gate: device scalars or null; state: 32 + 2 x blocks x
// 30 floats.
extern "C" int hs_icp_level(const float* packed, int hp, int wp, int ppb, int sppb,
                            const float* params, const float* prev_pose, const float* dist_gate,
                            const float* tight_gate, const float* pose0, float* state,
                            int n_iters, void* stream) {
  const int n = hp * wp;
  if (n <= 0 || sppb <= 0 || sppb > ppb || ppb % 32 || sppb % 32 || wp % 4)
    return (int)cudaErrorInvalidValue;
  const int blocks = (n + ppb - 1) / ppb;
  const int smem = sppb * ICP_ROWS * (int)sizeof(float);
  cudaError_t e =
      cudaFuncSetAttribute(icp_level_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  IcpParams prm;
  for (int i = 0; i < 32; ++i) prm.v[i] = params[i];
  void* args[] = {(void*)&packed,     (void*)&hp,    (void*)&wp,        (void*)&ppb,
                  (void*)&sppb,       (void*)&prm,   (void*)&prev_pose, (void*)&dist_gate,
                  (void*)&tight_gate, (void*)&pose0, (void*)&state,     (void*)&n_iters};
  e = cudaLaunchCooperativeKernel((const void*)icp_level_kernel, dim3(blocks), dim3(ICP_THREADS),
                                  args, (size_t)smem, (cudaStream_t)stream);
  return (int)e;
}

// Resident blocks an SM: out[0] the level kernel holding ``sppb`` pixels a
// block in shared memory.
extern "C" int hs_icp_occupancy(int sppb, int* out) {
  return hs_occupancy(icp_level_kernel, ICP_THREADS, sppb * ICP_ROWS * (int)sizeof(float), out);
}
