// K6: tile-grouped plane raycast (replaces housescan_tpu/ops/
// raycast_tiles.py _kernel via raycast_tiles_maps). See
// housescan_tpu_torch/ops/raycast_tiles.py for the plain version and the
// candidate selection.
//
// Bound: the candidates are read once and 9 rows a pixel written once,
// but the work is ~40 instructions per (pixel, usable candidate of its
// tile) pair tested, so on this card the floor is instruction issue, not
// bytes.
//
// Design. A block of 128 threads takes a quarter of an (8-row x 128-px)
// tile: thread t the pixels of column t in 2 consecutive rows, so every
// candidate read from shared memory serves 2 pixels, and a 640x480 frame
// (300 tiles of very uneven counts) is 1,200 small blocks, spread over
// the SMs. The block stages its tile's candidates in shared memory as
// four 16-byte vectors each: fields 0-11 ([n xyz, d - n.o], [centroid -
// o xyz, support r^2], [block id, ok, occluder, 0]) and the candidate's
// pixel box (rc_pixel_box), and counts the tile's usable ones while
// staging: the rows within a tile's count have ok = 1 and the rows past
// it are zero, so the loop runs to the last row with ok = 1 instead of
// over every slot. A pixel outside a candidate's box skips it (a warp
// whose pixels all lie outside skips it whole): the box holds every pixel
// whose ray can come within the support radius of its centre, which both
// a hit and an occluder event need, so the cull changes no output. Per (pixel,
// candidate) left, the plain version's float32 operations in its order: a
// plane candidate's ray-plane t is divided out only where den < 0
// (elsewhere it cannot hit), an occluder's closest approach. Each pixel
// keeps the nearest hit, ties to the larger block id (exact in any
// candidate order: a tile's block ids are unique), and the nearest
// occluder event. Output rows: depth, vertex xyz, normal xyz, block id
// (-1 = none), occluder t.
#include "common.cuh"

#define RC_THREADS 128  // one a column of a 128-px tile
#define RC_ROWS 2       // pixels a thread: consecutive rows of its column
#define RC_UNITS (8 / RC_ROWS)  // blocks a tile
#define RC_PREP 16      // floats a prepared candidate
#define RC_VEC 4        // 16-byte vectors staged a candidate: fields 0-11, pixel box
#define RC_BIG 1.0e9f
#define RC_MARGIN 1.0f  // pixels added on each side of a pixel box

// The pixel box of a candidate: columns [x, y] and rows [z, w] outside
// which no pixel's ray comes within sqrt(rad2) of the candidate's support
// centre r (relative to the camera), so no plane hit or occluder event
// (both put a point t dw, t > 0, inside that sphere) can happen there. In
// camera space the sphere is C = R r, radius rho; clear of the camera
// plane (Z^2 - rho^2 > 0.1 Z^2, Z > 0), its view cone holds x / z in
// (XZ -/+ rho sqrt(X^2 + Z^2 - rho^2)) / (Z^2 - rho^2), likewise y / z.
// The box is widened by RC_MARGIN pixels: the float32 error of its edges
// is ~1e-5 of their distance from the principal point (at most ~1e-4 with
// R R^T off the identity by 1e-4), that of the kernel's rays and hit
// points ~1e-3 pixel, so a pixel outside the box misses in float32 too;
// elsewhere (a sphere near the camera plane, a rotation not orthonormal to
// 1e-4, a NaN) the box is the whole image.
__device__ __forceinline__ float4 rc_pixel_box(const float* p, float rx, float ry, float rz,
                                               float rad2) {
  const float inf = __int_as_float(0x7f800000);
  const float4 all = make_float4(-inf, inf, -inf, inf);
  float dev = 0.0f;  // how far R R^T is from the identity
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const float d = p[3 * i] * p[3 * j] + p[3 * i + 1] * p[3 * j + 1] + p[3 * i + 2] * p[3 * j + 2];
      dev = fmaxf(dev, fabsf(d - (i == j ? 1.0f : 0.0f)));
    }
  const float X = p[0] * rx + p[1] * ry + p[2] * rz;
  const float Y = p[3] * rx + p[4] * ry + p[5] * rz;
  const float Z = p[6] * rx + p[7] * ry + p[8] * rz;
  const float q = Z * Z - rad2;
  if (!(dev <= 1e-4f && rad2 >= 0.0f && Z > 0.0f && q > 0.1f * Z * Z)) return all;
  const float rho = sqrtf(rad2);
  const float sx = rho * sqrtf(X * X + q), sy = rho * sqrtf(Y * Y + q);
  const float fx = p[12], fy = p[13], cx = p[14], cy = p[15];
  const float u0 = cx + fx * ((X * Z - sx) / q), u1 = cx + fx * ((X * Z + sx) / q);
  const float v0 = cy + fy * ((Y * Z - sy) / q), v1 = cy + fy * ((Y * Z + sy) / q);
  return make_float4(fminf(u0, u1) - RC_MARGIN, fmaxf(u0, u1) + RC_MARGIN,
                     fminf(v0, v1) - RC_MARGIN, fmaxf(v0, v1) + RC_MARGIN);
}

__global__ void __launch_bounds__(RC_THREADS)
raycast_tiles_kernel(const float* __restrict__ cand, int max_ct, const float* __restrict__ p,
                     float* __restrict__ out, int h, int w_pad, int n_ut) {
  extern __shared__ float4 s_c[];  // [max_ct][RC_VEC]
  __shared__ int s_n;
  const int g = blockIdx.x / RC_UNITS, unit = blockIdx.x % RC_UNITS;
  const int tid = threadIdx.x;
  if (tid == 0) s_n = 0;
  __syncthreads();
  const float4* src = reinterpret_cast<const float4*>(cand + (size_t)g * max_ct * RC_PREP);
  for (int k = tid; k < max_ct; k += RC_THREADS) {
    const float4 c0 = src[k * (RC_PREP / 4)], c1 = src[k * (RC_PREP / 4) + 1];
    const float4 c2 = src[k * (RC_PREP / 4) + 2];
    s_c[k * RC_VEC] = c0;
    s_c[k * RC_VEC + 1] = c1;
    s_c[k * RC_VEC + 2] = c2;
    if (c2.y > 0.5f) {
      atomicMax(&s_n, k + 1);
      s_c[k * RC_VEC + 3] = rc_pixel_box(p, c1.x, c1.y, c1.z, c1.w);
    }
  }
  __syncthreads();
  const int n = s_n;

  const float r00 = p[0], r01 = p[1], r02 = p[2], r10 = p[3], r11 = p[4], r12 = p[5];
  const float r20 = p[6], r21 = p[7], r22 = p[8];
  const float tx = p[9], ty = p[10], tz = p[11];
  const float fx = p[12], fy = p[13], cx = p[14], cy = p[15];
  const float z_min = p[16];
  const int b = g / n_ut, ut = g % n_ut;
  const int row0 = unit * RC_ROWS;
  const float u_pix = (float)(ut * 128) + (float)tid;
  const float dcx = (u_pix - cx) / fx;
  float dwx[RC_ROWS], dwy[RC_ROWS], dwz[RC_ROWS], d2[RC_ROWS];
  float best_t[RC_ROWS], best_bid[RC_ROWS], bnx[RC_ROWS], bny[RC_ROWS], bnz[RC_ROWS];
  float best_o[RC_ROWS];
#pragma unroll
  for (int r = 0; r < RC_ROWS; ++r) {
    const float v_pix = (float)(b * 8) + (float)(row0 + r);
    const float dcy = (v_pix - cy) / fy;
    dwx[r] = dcx * r00 + dcy * r10 + r20;
    dwy[r] = dcx * r01 + dcy * r11 + r21;
    dwz[r] = dcx * r02 + dcy * r12 + r22;
    d2[r] = dwx[r] * dwx[r] + dwy[r] * dwy[r] + dwz[r] * dwz[r];
    best_t[r] = RC_BIG;
    best_bid[r] = -1.0f;
    bnx[r] = bny[r] = bnz[r] = 0.0f;
    best_o[r] = RC_BIG;
  }

  const float v_first = (float)(b * 8 + row0), v_last = (float)(b * 8 + row0 + RC_ROWS - 1);
  for (int k = 0; k < n; ++k) {
    const float4 c2 = s_c[k * RC_VEC + 2];  // block id, ok, occluder
    if (!(c2.y > 0.5f)) continue;
    const float4 box = s_c[k * RC_VEC + 3];
    if (box.w < v_first || box.z > v_last || u_pix < box.x || u_pix > box.y) continue;
    const float4 c1 = s_c[k * RC_VEC + 1];  // centroid - o, support r^2
    if (c2.z < 0.5f) {
      const float4 c0 = s_c[k * RC_VEC];  // n, d - n.o
#pragma unroll
      for (int r = 0; r < RC_ROWS; ++r) {
        const float den = c0.x * dwx[r] + c0.y * dwy[r] + c0.z * dwz[r];
        if (den < 0.0f) {  // else no hit: tq is never used
          const float safe = den < -1e-9f ? den : -1e-9f;
          const float tq = c0.w / safe;
          const float qx = tq * dwx[r] - c1.x, qy = tq * dwy[r] - c1.y, qz = tq * dwz[r] - c1.z;
          const float dist2 = qx * qx + qy * qy + qz * qz;
          if (dist2 <= c1.w && tq > z_min &&
              (tq < best_t[r] || (tq == best_t[r] && c2.x > best_bid[r]))) {
            best_t[r] = tq;
            best_bid[r] = c2.x;
            bnx[r] = c0.x;
            bny[r] = c0.y;
            bnz[r] = c0.z;
          }
        }
      }
    } else if (c2.z > 0.5f) {
#pragma unroll
      for (int r = 0; r < RC_ROWS; ++r) {
        const float ts = (c1.x * dwx[r] + c1.y * dwy[r] + c1.z * dwz[r]) / d2[r];
        const float ox = ts * dwx[r] - c1.x, oy = ts * dwy[r] - c1.y, oz = ts * dwz[r] - c1.z;
        const float miss2 = ox * ox + oy * oy + oz * oz;
        if (miss2 <= c1.w && ts > z_min) best_o[r] = fminf(best_o[r], ts);
      }
    }
  }

  const size_t plane = (size_t)h * w_pad;
#pragma unroll
  for (int r = 0; r < RC_ROWS; ++r) {
    const bool got = best_t[r] < RC_BIG;
    const float tq1 = got ? best_t[r] : 0.0f;
    const size_t o = (size_t)(b * 8 + row0 + r) * w_pad + ut * 128 + tid;
    out[o] = tq1;
    out[plane + o] = got ? tx + tq1 * dwx[r] : 0.0f;
    out[2 * plane + o] = got ? ty + tq1 * dwy[r] : 0.0f;
    out[3 * plane + o] = got ? tz + tq1 * dwz[r] : 0.0f;
    out[4 * plane + o] = got ? bnx[r] : 0.0f;
    out[5 * plane + o] = got ? bny[r] : 0.0f;
    out[6 * plane + o] = got ? bnz[r] : 0.0f;
    out[7 * plane + o] = got ? best_bid[r] : -1.0f;
    out[8 * plane + o] = best_o[r];
  }
}

static int rc_smem(int max_ct) { return max_ct * RC_VEC * (int)sizeof(float4); }

extern "C" int hs_raycast_tiles(const float* cand, int n_tiles, int max_ct, const float* params,
                                float* out, int h, int w_pad, void* stream) {
  if (n_tiles <= 0) return 0;
  const int n_ut = w_pad / 128;
  const int smem = rc_smem(max_ct);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(raycast_tiles_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  raycast_tiles_kernel<<<n_tiles * RC_UNITS, RC_THREADS, smem, (cudaStream_t)stream>>>(
      cand, max_ct, params, out, h, w_pad, n_ut);
  return (int)cudaGetLastError();
}

// Resident blocks an SM: out[0] at ``max_ct`` candidates a tile.
extern "C" int hs_raycast_tiles_occupancy(int max_ct, int* out) {
  return hs_occupancy(raycast_tiles_kernel, RC_THREADS, rc_smem(max_ct), out);
}
