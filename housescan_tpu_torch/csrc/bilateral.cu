// K1: bilateral depth filter (replaces housescan_tpu/ops/preprocess_pallas.py
// _kernel via bilateral_filter_pallas). See housescan_tpu_torch/ops/
// preprocess_cuda.py for the plain version.
//
// Bound: instruction issue. At 640 x 480 and radius 3 the filter reads
// 1.2 MB and writes 1.2 MB (0.0007 ms of device memory) and does ~10 float
// operations a tap (0.002 ms at the float32 rate, which counts an FMA as
// two: --fmad=false forbids FMAs, so every multiply and add issues alone).
// What is left is ~15 instructions a tap and pixel, 15 M of them: 7.2 M
// warp instructions, an estimated 0.0069 ms at four a clock on 132 SMs at
// 1,980 MHz (from the static SASS count).
//
// Design. A block of 32 x 4 threads owns a 128 x 4 tile of the output. It
// stages the tile and an R-pixel halo in shared memory, 0 outside the
// image (0 is "invalid" and "outside" alike, as the reference pads), so
// the taps need no bounds compares and no global loads. Each thread
// computes 4 adjacent pixels of a row: per tap row it loads the 4 + 2R
// values it needs with 16-byte shared loads, and every tap of that row
// reads them from registers. The radius is a template parameter
// (instantiated 0..7): the taps unroll, and each tap's spatial weight is
// an element of the by-value parameter at a compile-time index, which the
// multiply reads from the constant bank. The weights are computed on the
// host in double and rounded to float, as math.exp is in the reference.
// Each pixel runs the plain version's float32 operations in its order (dy
// outer, dx inner; tap * wr, then * wr; the two sums; one division), so
// the result is bit-identical under --fmad=false. CUDA C++ rather than
// Triton: the per-radius template makes each tap's weight a constant of a
// fully unrolled loop, and the tap rows' register reuse is explicit.
#include <math.h>

#include "common.cuh"

#define HS_BILATERAL_MAX_R 7
#define BL_BX 32  // threads a row of the block
#define BL_BY 4   // rows of the block
#define BL_P 4    // adjacent pixels a thread
#define BL_TILE_W (BL_BX * BL_P)

struct BilateralTaps {
  float w[(2 * HS_BILATERAL_MAX_R + 1) * (2 * HS_BILATERAL_MAX_R + 1)];
};

template <int R>
__global__ void __launch_bounds__(BL_BX* BL_BY)
bilateral_kernel(const float* __restrict__ depth, float* __restrict__ out, int h, int w,
                 BilateralTaps taps, float inv_9sd2) {
  constexpr int kVec = (BL_P + 2 * R + 3) / 4;  // 16-byte loads a tap row
  constexpr int kRowW = BL_TILE_W + 4 * ((2 * R + 3) / 4);  // >= (BL_BX - 1) * BL_P + 4 kVec
  constexpr int kRows = BL_BY + 2 * R;
  __shared__ __align__(16) float s_tile[kRows * kRowW];

  const int tx = threadIdx.x, ty = threadIdx.y, tid = ty * BL_BX + tx;
  const int x0 = blockIdx.x * BL_TILE_W, y0 = blockIdx.y * BL_BY;
  // stage: s_tile[r][c] holds depth[y0 - R + r][x0 - R + c], 0 outside
  for (int i = tid; i < kRows * kRowW; i += BL_BX * BL_BY) {
    const int r = i / kRowW, c = i - r * kRowW;
    const int gy = y0 - R + r, gx = x0 - R + c;
    s_tile[i] = (gy >= 0 && gy < h && gx >= 0 && gx < w) ? __ldg(&depth[gy * w + gx]) : 0.0f;
  }
  __syncthreads();

  // pixel j of this thread is (y0 + ty, x0 + BL_P tx + j); tap (dy, dx)
  // reads depth[y - dy][x - dx], staged at row ty + R - dy, column
  // BL_P tx + j + R - dx
  float c[BL_P], ws[BL_P], vs[BL_P];
  bool valid[BL_P];
  {
    const float* row = s_tile + (ty + R) * kRowW + BL_P * tx + R;
#pragma unroll
    for (int j = 0; j < BL_P; ++j) {
      c[j] = row[j];
      valid[j] = c[j] > 0.0f;
      ws[j] = 0.0f;
      vs[j] = 0.0f;
    }
  }
#pragma unroll
  for (int dy = -R; dy <= R; ++dy) {
    float v[4 * kVec];
    const float4* row = reinterpret_cast<const float4*>(s_tile + (ty + R - dy) * kRowW) + tx;
#pragma unroll
    for (int q = 0; q < kVec; ++q) {
      const float4 f = row[q];
      v[4 * q] = f.x;
      v[4 * q + 1] = f.y;
      v[4 * q + 2] = f.z;
      v[4 * q + 3] = f.w;
    }
#pragma unroll
    for (int dx = -R; dx <= R; ++dx) {
      const float tap = taps.w[(dy + R) * (2 * R + 1) + (dx + R)];
#pragma unroll
      for (int j = 0; j < BL_P; ++j) {
        const float s = v[j + R - dx];
        const bool ok = (s > 0.0f) && valid[j];
        const float dd = s - c[j];
        const float wr = hs_clamp_min(1.0f - dd * dd * inv_9sd2, 0.0f);
        float wt = tap * wr * wr;
        wt = ok ? wt : 0.0f;
        ws[j] = ws[j] + wt;
        vs[j] = vs[j] + wt * s;
      }
    }
  }
  const int y = y0 + ty;
  if (y >= h) return;
#pragma unroll
  for (int j = 0; j < BL_P; ++j) {
    const int x = x0 + BL_P * tx + j;
    const float o = ws[j] > 0.0f ? vs[j] / hs_clamp_min(ws[j], 1e-12f) : 0.0f;
    if (x < w) out[y * w + x] = valid[j] ? o : 0.0f;
  }
}

template <int R>
static cudaError_t bl_launch(const float* depth, float* out, int h, int w,
                             const BilateralTaps& taps, float inv_9sd2, cudaStream_t stream) {
  const dim3 block(BL_BX, BL_BY);
  const dim3 grid((w + BL_TILE_W - 1) / BL_TILE_W, (h + BL_BY - 1) / BL_BY);
  bilateral_kernel<R><<<grid, block, 0, stream>>>(depth, out, h, w, taps, inv_9sd2);
  return cudaGetLastError();
}

extern "C" int hs_bilateral(const float* depth, float* out, int h, int w, int radius,
                            double sigma_space, double sigma_depth, void* stream) {
  if (radius < 0 || radius > HS_BILATERAL_MAX_R) return (int)cudaErrorInvalidValue;
  if (h <= 0 || w <= 0) return 0;
  // taps[(dy + r)(2r + 1) + dx + r]: exp in double, rounded to float
  BilateralTaps taps;
  const double inv_2ss = 0.5 / (sigma_space * sigma_space);
  int k = 0;
  for (int dy = -radius; dy <= radius; ++dy)
    for (int dx = -radius; dx <= radius; ++dx)
      taps.w[k++] = (float)exp((double)(-(dy * dy + dx * dx)) * inv_2ss);
  const float inv_9sd2 = (float)(1.0 / (9.0 * sigma_depth * sigma_depth));
  const cudaStream_t s = (cudaStream_t)stream;
  cudaError_t e = cudaErrorInvalidValue;
  switch (radius) {
    case 0: e = bl_launch<0>(depth, out, h, w, taps, inv_9sd2, s); break;
    case 1: e = bl_launch<1>(depth, out, h, w, taps, inv_9sd2, s); break;
    case 2: e = bl_launch<2>(depth, out, h, w, taps, inv_9sd2, s); break;
    case 3: e = bl_launch<3>(depth, out, h, w, taps, inv_9sd2, s); break;
    case 4: e = bl_launch<4>(depth, out, h, w, taps, inv_9sd2, s); break;
    case 5: e = bl_launch<5>(depth, out, h, w, taps, inv_9sd2, s); break;
    case 6: e = bl_launch<6>(depth, out, h, w, taps, inv_9sd2, s); break;
    case 7: e = bl_launch<7>(depth, out, h, w, taps, inv_9sd2, s); break;
  }
  return (int)e;
}

// Resident blocks an SM: out[0] the filter at the default radius 3.
extern "C" int hs_bilateral_occupancy(int, int* out) {
  return hs_occupancy(bilateral_kernel<3>, BL_BX * BL_BY, 0, out);
}
