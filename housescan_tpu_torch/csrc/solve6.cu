// K2: the damped 6x6 solve + twist exponential + pose compose as one
// launch (replaces housescan_tpu/ops/solve6_pallas.py _kernel via
// solve_twist_compose). See housescan_tpu_torch/ops/solve6.py for the
// plain version and the design note.
//
// One block of one thread runs the device function hs_solve_twist
// (solve6.cuh, which K3 inlines too) on the 58 floats [A 36, b 6, pose 16]
// and writes [pose 16, step norm], all in device memory on the stream.
#include "common.cuh"
#include "solve6.cuh"

__global__ void solve6_kernel(const float* __restrict__ abp, float* __restrict__ out,
                              float damping, float max_step) {
  float a[36], b[6], pose[16], res[17];
  for (int i = 0; i < 36; ++i) a[i] = abp[i];
  for (int i = 0; i < 6; ++i) b[i] = abp[36 + i];
  for (int i = 0; i < 16; ++i) pose[i] = abp[42 + i];
  hs_solve_twist(a, b, pose, damping, max_step, res);
  for (int i = 0; i < 17; ++i) out[i] = res[i];
}

extern "C" int hs_solve6(const float* abp, float* out, float damping, float max_step,
                         void* stream) {
  solve6_kernel<<<1, 1, 0, (cudaStream_t)stream>>>(abp, out, damping, max_step);
  return (int)cudaGetLastError();
}

// Resident blocks an SM: out[0] the one-thread solve.
extern "C" int hs_solve6_occupancy(int, int* out) { return hs_occupancy(solve6_kernel, 1, 0, out); }
