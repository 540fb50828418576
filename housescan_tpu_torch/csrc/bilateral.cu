// K1: bilateral depth filter (replaces housescan_tpu/ops/preprocess_pallas.py
// _kernel via bilateral_filter_pallas). See housescan_tpu_torch/ops/
// preprocess_cuda.py for the plain version and the design note.
//
// One thread per pixel; taps read through the read-only cache. Spatial
// weights arrive in the kernel's parameter space, computed on the host
// with exp() in double and rounded to float, as math.exp is.
#include <math.h>

#include "common.cuh"

#define HS_BILATERAL_MAX_R 7

struct BilateralTaps {
  float w[(2 * HS_BILATERAL_MAX_R + 1) * (2 * HS_BILATERAL_MAX_R + 1)];
};

__global__ void bilateral_kernel(const float* __restrict__ depth, float* __restrict__ out,
                                 int h, int w, int radius, BilateralTaps taps,
                                 float inv_9sd2) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  if (x >= w || y >= h) return;
  const float c = depth[y * w + x];
  const bool valid = c > 0.0f;
  float weight_sum = 0.0f, value_sum = 0.0f;
  int k = 0;
  for (int dy = -radius; dy <= radius; ++dy) {
    for (int dx = -radius; dx <= radius; ++dx, ++k) {
      // the shifted image holds depth[p - (dy, dx)], zero outside
      const int sy = y - dy, sx = x - dx;
      const float s =
          (sy >= 0 && sy < h && sx >= 0 && sx < w) ? __ldg(&depth[sy * w + sx]) : 0.0f;
      const bool ok = (s > 0.0f) && valid;
      const float dd = s - c;
      const float wr = hs_clamp_min(1.0f - dd * dd * inv_9sd2, 0.0f);
      float wt = taps.w[k] * wr * wr;
      wt = ok ? wt : 0.0f;
      weight_sum = weight_sum + wt;
      value_sum = value_sum + wt * s;
    }
  }
  const float o = weight_sum > 0.0f ? value_sum / hs_clamp_min(weight_sum, 1e-12f) : 0.0f;
  out[y * w + x] = valid ? o : 0.0f;
}

extern "C" int hs_bilateral(const float* depth, float* out, int h, int w, int radius,
                            double sigma_space, double sigma_depth, void* stream) {
  if (radius < 0 || radius > HS_BILATERAL_MAX_R) return (int)cudaErrorInvalidValue;
  BilateralTaps taps;
  const double inv_2ss = 0.5 / (sigma_space * sigma_space);
  int k = 0;
  for (int dy = -radius; dy <= radius; ++dy)
    for (int dx = -radius; dx <= radius; ++dx)
      taps.w[k++] = (float)exp((double)(-(dy * dy + dx * dx)) * inv_2ss);
  const float inv_9sd2 = (float)(1.0 / (9.0 * sigma_depth * sigma_depth));
  const dim3 block(32, 8);
  const dim3 grid((w + 31) / 32, (h + 7) / 8);
  bilateral_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(depth, out, h, w, radius, taps,
                                                             inv_9sd2);
  return (int)cudaGetLastError();
}

// Resident blocks an SM: out[0] the filter at its 32 x 8 block.
extern "C" int hs_bilateral_occupancy(int, int* out) {
  return hs_occupancy(bilateral_kernel, 256, 0, out);
}
