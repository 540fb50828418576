// K6: tile-grouped plane raycast (replaces housescan_tpu/ops/
// raycast_tiles.py _kernel via raycast_tiles_maps). See
// housescan_tpu_torch/ops/raycast_tiles.py for the plain version and the
// design note.
//
// One block of 1024 threads per (8-row x 128-px) tile, one thread per
// pixel. The tile's prepared candidates (max_ct x 16 floats) are staged in
// shared memory; each thread keeps the nearest hit (ties to the larger
// block id) and the nearest occluder event over all of them. Output rows:
// depth, vertex xyz, normal xyz, block id (-1 = none), occluder t.
#include "common.cuh"

#define RC_THREADS 1024
#define RC_PREP 16
#define RC_BIG 1.0e9f

__global__ void __launch_bounds__(RC_THREADS)
raycast_tiles_kernel(const float* __restrict__ cand, int max_ct, const float* __restrict__ p,
                     float* __restrict__ out, int h, int w_pad, int n_ut) {
  extern __shared__ float s_c[];
  const int g = blockIdx.x;
  const float* src = cand + (size_t)g * max_ct * RC_PREP;
  for (int i = threadIdx.x; i < max_ct * RC_PREP; i += RC_THREADS) s_c[i] = src[i];
  __syncthreads();

  const float r00 = p[0], r01 = p[1], r02 = p[2], r10 = p[3], r11 = p[4], r12 = p[5];
  const float r20 = p[6], r21 = p[7], r22 = p[8];
  const float tx = p[9], ty = p[10], tz = p[11];
  const float fx = p[12], fy = p[13], cx = p[14], cy = p[15];
  const float z_min = p[16];
  const int b = g / n_ut, ut = g % n_ut;
  const int row = threadIdx.x >> 7, col = threadIdx.x & 127;
  const float u_pix = (float)(ut * 128) + (float)col;
  const float v_pix = (float)(b * 8) + (float)row;
  const float dcx = (u_pix - cx) / fx;
  const float dcy = (v_pix - cy) / fy;
  const float dwx = dcx * r00 + dcy * r10 + r20;
  const float dwy = dcx * r01 + dcy * r11 + r21;
  const float dwz = dcx * r02 + dcy * r12 + r22;
  const float d2 = dwx * dwx + dwy * dwy + dwz * dwz;

  float best_t = RC_BIG, best_bid = -1.0f, bnx = 0.0f, bny = 0.0f, bnz = 0.0f;
  float best_o = RC_BIG;
  for (int k = 0; k < max_ct; ++k) {
    const float* c = s_c + k * RC_PREP;
    const float ok = c[9];
    if (!(ok > 0.5f)) continue;
    const float nx = c[0], ny = c[1], nz = c[2], fnum = c[3];
    const float rx = c[4], ry = c[5], rz = c[6], rad2 = c[7], bid = c[8], occf = c[10];
    if (occf < 0.5f) {
      const float den = nx * dwx + ny * dwy + nz * dwz;
      const float safe = fabsf(den) > 1e-9f ? den : -1e-9f;
      const float tq = fnum / safe;
      const float qx = tq * dwx - rx, qy = tq * dwy - ry, qz = tq * dwz - rz;
      const float dist2 = qx * qx + qy * qy + qz * qz;
      const bool hit = (den < 0.0f) && (dist2 <= rad2) && (tq > z_min);
      if (hit && (tq < best_t || (tq == best_t && bid > best_bid))) {
        best_t = tq;
        best_bid = bid;
        bnx = nx;
        bny = ny;
        bnz = nz;
      }
    } else {
      const float ts = (rx * dwx + ry * dwy + rz * dwz) / d2;
      const float ox = ts * dwx - rx, oy = ts * dwy - ry, oz = ts * dwz - rz;
      const float miss2 = ox * ox + oy * oy + oz * oz;
      if (miss2 <= rad2 && ts > z_min) best_o = fminf(best_o, ts);
    }
  }
  const bool got = best_t < RC_BIG;
  const float tq1 = got ? best_t : 0.0f;
  const size_t plane = (size_t)h * w_pad;
  const size_t o = (size_t)(b * 8 + row) * w_pad + ut * 128 + col;
  out[o] = tq1;
  out[plane + o] = got ? tx + tq1 * dwx : 0.0f;
  out[2 * plane + o] = got ? ty + tq1 * dwy : 0.0f;
  out[3 * plane + o] = got ? tz + tq1 * dwz : 0.0f;
  out[4 * plane + o] = got ? bnx : 0.0f;
  out[5 * plane + o] = got ? bny : 0.0f;
  out[6 * plane + o] = got ? bnz : 0.0f;
  out[7 * plane + o] = got ? best_bid : -1.0f;
  out[8 * plane + o] = best_o;
}

extern "C" int hs_raycast_tiles(const float* cand, int n_tiles, int max_ct, const float* params,
                                float* out, int h, int w_pad, void* stream) {
  if (n_tiles <= 0) return 0;
  const int n_ut = w_pad / 128;
  const int smem = max_ct * RC_PREP * (int)sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(raycast_tiles_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  raycast_tiles_kernel<<<n_tiles, RC_THREADS, smem, (cudaStream_t)stream>>>(
      cand, max_ct, params, out, h, w_pad, n_ut);
  return (int)cudaGetLastError();
}

// Resident blocks an SM: out[0] at ``max_ct`` candidates a tile.
extern "C" int hs_raycast_tiles_occupancy(int max_ct, int* out) {
  return hs_occupancy(raycast_tiles_kernel, RC_THREADS, max_ct * RC_PREP * (int)sizeof(float),
                      out);
}
