// K3: every Gauss-Newton iteration of one ICP pyramid level (replaces
// housescan_tpu/ops/icp_pallas.py _kernel via icp_level_pallas). See
// housescan_tpu_torch/ops/icp_cuda.py for the plain version and the
// design note.
//
// Per iteration, two launches on the stream, no host synchronisation:
//   icp_assoc: one thread per pixel of the packed (19, hp, wp) maps; the
//     block's 30 partial sums (21 A-upper, 6 b, sq, n_corr, visible-model
//     count) go to partials[block][30] through a fixed-order tree;
//   icp_solve: one block sums the partials in block order in double, runs
//     the adaptive-gate state machine and the 6x6 solve, and updates the
//     pose in the state buffer.
// state[32]: 0-15 pose, 16 rmse, 17 n_corr, 18 iterations run,
// 19 converged, 20 visible-model pixels, 21 widen_until.
#include "common.cuh"
#include "solve6.cuh"

#define ICP_BLOCK 256
#define ICP_NP 30  // partial sums per block

enum {
  ST_RMSE = 16, ST_CORR = 17, ST_ITERS = 18, ST_CONV = 19, ST_MOK = 20, ST_WIDEN = 21,
};

__global__ void icp_init(const float* __restrict__ pose0, float* __restrict__ state) {
  const int t = threadIdx.x;
  if (t < 32) state[t] = t < 16 ? pose0[t] : 0.0f;
}

__global__ void __launch_bounds__(ICP_BLOCK)
icp_assoc(const float* __restrict__ m, int hp, int wp, const float* __restrict__ p,
          const float* __restrict__ state, float* __restrict__ partials, int it) {
  if (state[ST_CONV] > 0.5f) return;  // converged: the whole grid idles
  __shared__ float sh[ICP_BLOCK / 32][ICP_NP];
  const int idx = blockIdx.x * ICP_BLOCK + threadIdx.x;
  const int n = hp * wp;
  float v[ICP_NP];
#pragma unroll
  for (int k = 0; k < ICP_NP; ++k) v[k] = 0.0f;

  if (idx < n) {
    const float r00 = state[0], r01 = state[1], r02 = state[2];
    const float r10 = state[4], r11 = state[5], r12 = state[6];
    const float r20 = state[8], r21 = state[9], r22 = state[10];
    const float tx = state[12], ty = state[13], tz = state[14];
    const float pr00 = p[0], pr01 = p[1], pr02 = p[2];
    const float pr10 = p[3], pr11 = p[4], pr12 = p[5];
    const float pr20 = p[6], pr21 = p[7], pr22 = p[8];
    const float ptx = p[9], pty = p[10], ptz = p[11];
    const float fx = p[12], fy = p[13], cx = p[14], cy = p[15];
    const float gate = p[16], sin2 = p[18], huber = p[19];
    const float h_valid = p[22], w_valid = p[23];
    const float dist2 = (it < (int)state[ST_WIDEN]) ? p[17] : p[24];

    const float* q = m + idx;
    const size_t pl = (size_t)n;
    const float lvx = q[0], lvy = q[pl], lvz = q[2 * pl];
    const float lnx = q[3 * pl], lny = q[4 * pl], lnz = q[5 * pl];
    const float mvx = q[6 * pl], mvy = q[7 * pl], mvz = q[8 * pl];
    const float mnx = q[9 * pl], mny = q[10 * pl], mnz = q[11 * pl];
    const float mok = q[12 * pl];
    const float gux = q[13 * pl], guy = q[14 * pl], guz = q[15 * pl];
    const float gvx = q[16 * pl], gvy = q[17 * pl], gvz = q[18 * pl];
    const float py = (float)(idx / wp);
    const float px = (float)(idx % wp);

    const float vwx = lvx * r00 + lvy * r10 + lvz * r20 + tx;
    const float vwy = lvx * r01 + lvy * r11 + lvz * r21 + ty;
    const float vwz = lvx * r02 + lvy * r12 + lvz * r22 + tz;
    const float nwx = lnx * r00 + lny * r10 + lnz * r20;
    const float nwy = lnx * r01 + lny * r11 + lnz * r21;
    const float nwz = lnx * r02 + lny * r12 + lnz * r22;
    const bool live_ok = (lvz > 0.0f) && (lnx * lnx + lny * lny + lnz * lnz > 0.25f);

    const float dxw = vwx - ptx, dyw = vwy - pty, dzw = vwz - ptz;
    const float xc = dxw * pr00 + dyw * pr01 + dzw * pr02;
    const float yc = dxw * pr10 + dyw * pr11 + dzw * pr12;
    const float zc = dxw * pr20 + dyw * pr21 + dzw * pr22;
    const float safe_z = zc > 1e-6f ? zc : 1.0f;
    const float u = fx * xc / safe_z + cx;
    const float vv = fy * yc / safe_z + cy;
    const bool inb = (zc > 1e-6f) && (u >= 0.0f) && (u <= w_valid - 1.0f) && (vv >= 0.0f) &&
                     (vv <= h_valid - 1.0f);
    const bool in_img = (py < h_valid) && (px < w_valid);
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
      for (int j = i; j < 6; ++j) v[k++] = wg[i] * wg[j];
#pragma unroll
    for (int i = 0; i < 6; ++i) v[21 + i] = wg[i] * wr;
    v[27] = wr * wr;
    v[28] = corr ? 1.0f : 0.0f;
    v[29] = (mok > 0.5f && in_img) ? 1.0f : 0.0f;
  }

  // fixed-order block reduction: xor tree within warps, warps in order
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < ICP_NP; ++k) {
    float s = v[k];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s = s + __shfl_xor_sync(HS_FULL_MASK, s, o);
    if (lane == 0) sh[warp][k] = s;
  }
  __syncthreads();
  if (threadIdx.x < ICP_NP) {
    float s = sh[0][threadIdx.x];
    for (int w8 = 1; w8 < ICP_BLOCK / 32; ++w8) s = s + sh[w8][threadIdx.x];
    partials[(size_t)blockIdx.x * ICP_NP + threadIdx.x] = s;
  }
}

__global__ void icp_solve(const float* __restrict__ partials, int n_blocks,
                          const float* __restrict__ p, float* __restrict__ state, int it,
                          int n_iters) {
  __shared__ double acc[ICP_NP];
  if (state[ST_CONV] > 0.5f) return;
  const int t = threadIdx.x;
  if (t < ICP_NP) {
    double s = 0.0;
    for (int b = 0; b < n_blocks; ++b) s += (double)partials[(size_t)b * ICP_NP + t];
    acc[t] = s;
  }
  __syncthreads();
  if (t != 0) return;

  float A[ICP_NP];
  for (int k = 0; k < ICP_NP; ++k) A[k] = (float)acc[k];
  if (it == 0) state[ST_MOK] = A[29];
  const float mok_total = state[ST_MOK];
  float a_flat[36];
  int k = 0;
  for (int i = 0; i < 6; ++i)
    for (int j = i; j < 6; ++j) {
      a_flat[i * 6 + j] = A[k];
      a_flat[j * 6 + i] = A[k];
      ++k;
    }
  float pose[16], res[17];
  for (int i = 0; i < 16; ++i) pose[i] = state[i];
  hs_solve_twist(a_flat, A + 21, pose, p[20], p[21], res);

  const float norm = res[16];
  const float n_corr = A[28];
  const float rmse = sqrtf(A[27] / hs_clamp_min(n_corr, 1.0f));
  const bool healthy = n_corr >= p[25] * mok_total;
  const int widen = (int)state[ST_WIDEN];
  const bool was_tight = it >= widen;
  const bool trigger = !healthy && was_tight;
  for (int i = 0; i < 16; ++i) state[i] = res[i];
  state[ST_RMSE] = rmse;
  state[ST_CORR] = n_corr;
  state[ST_ITERS] = state[ST_ITERS] + 1.0f;
  state[ST_WIDEN] = (float)(trigger ? it + 1 + (n_iters - it) / 2 : widen);
  state[ST_CONV] = (norm <= 1e-5f && healthy && was_tight) ? 1.0f : 0.0f;
}

extern "C" int hs_icp_level(const float* packed, int hp, int wp, const float* params,
                            const float* pose0, float* state, float* partials, int n_iters,
                            void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int n_blocks = (hp * wp + ICP_BLOCK - 1) / ICP_BLOCK;
  icp_init<<<1, 32, 0, s>>>(pose0, state);
  for (int it = 0; it < n_iters; ++it) {
    icp_assoc<<<n_blocks, ICP_BLOCK, 0, s>>>(packed, hp, wp, params, state, partials, it);
    icp_solve<<<1, 32, 0, s>>>(partials, n_blocks, params, state, it, n_iters);
  }
  return (int)cudaGetLastError();
}
