// K2: the damped 6x6 solve + twist exponential + pose compose as one
// launch (replaces housescan_tpu/ops/solve6_pallas.py _kernel, line 174,
// called at :198 by solve_twist_compose). See
// housescan_tpu_torch/ops/solve6.py for the plain version.
//
// Bound: latency. 58 floats in and 17 out (a byte bound of ~1e-7 ms) and
// ~700 float operations, but one chain: each Cholesky column needs the one
// before it, each triangular-solve row the rows before it. On that chain
// sit ~30 IEEE divisions and ~9 square roots (--fmad=false keeps them
// exact), each a multi-instruction sequence that ends in a branch to its
// slow path, which the scheduler cannot overlap with the next. The floor
// is a launch's own latency, which chip_smoke.py reads beside the kernel
// as the device time of an empty one-thread kernel.
//
// Design: one warp that runs the chain on every lane (the same values, so
// no shuffle sits on it) from registers, and spends its lanes where the
// chain has independent work:
//   * A, b and the pose are read where they lie (three pointers: no
//     concatenation launch before the kernel);
//   * after the Cholesky (solve6.cuh, as K3's) lane j < 6 computes the
//     correctly rounded reciprocal of L[j][j], all six at once, shuffled to
//     every lane;
//   * each division of the four triangular solves by L[i][i] is then
//     taken from that reciprocal with two FMA corrections (Markstein: with
//     the reciprocal correctly rounded and the quotient faithful, the last
//     correction gives the correctly rounded quotient, which is the IEEE
//     division's result bit for bit); an operand outside [2^-60, 2^60] in
//     magnitude (zeros, non-finite values) takes the division itself;
//   * the guards, Rodrigues and the compose as solve6.cuh's, but for the
//     sine's last Taylor term: the plain version divides by a Python
//     scalar, which PyTorch runs on the card as a multiply by its float
//     reciprocal, and so does this kernel.
// Each scalar keeps the plain version's operation order: bit-identical.
// Spreading the Cholesky's columns over lanes puts shuffles on the chain
// and read slower than this.
#include "common.cuh"
#include "solve6.cuh"

#define S6_LANES 32

// s / d, correctly rounded, from r = RN(1 / d) (see above).
__device__ __forceinline__ float s6_div(float s, float d, float r) {
  const float y0 = s * r;
  const float e0 = fmaf(-d, y0, s);
  const float y1 = fmaf(e0, r, y0);  // faithful
  const float e1 = fmaf(-d, y1, s);  // exact
  float q = fmaf(e1, r, y1);
  const float as = fabsf(s), ad = fabsf(d);
  if (!(as >= 0x1p-60f && as <= 0x1p60f && ad >= 0x1p-60f && ad <= 0x1p60f)) q = s / d;
  return q;
}

// A solve's division by d = L[i][i] from its reciprocal r[i].
struct S6DivRecip {
  float r[6];
  __device__ __forceinline__ float operator()(float s, float d, int i) const {
    return s6_div(s, d, r[i]);
  }
};

__global__ void __launch_bounds__(S6_LANES)
solve6_kernel(const float* __restrict__ a_in, const float* __restrict__ b_in,
              const float* __restrict__ pose_in, float* __restrict__ out, float damping,
              float max_step) {
  const int lane = threadIdx.x;
  float a[36], b[6], pose[16], res[17];
#pragma unroll
  for (int i = 0; i < 36; ++i) a[i] = a_in[i];
#pragma unroll
  for (int i = 0; i < 6; ++i) b[i] = b_in[i];
#pragma unroll
  for (int i = 0; i < 16; ++i) pose[i] = pose_in[i];

  float L[6][6];
  const bool ok = hs_cholesky6(a, hs_solve_lambda(a, damping), L);
  // the six reciprocals: lane j < 6 the j-th, then every lane all six
  float d = L[0][0];
  for (int j = 1; j < 6; ++j)
    if (lane == j) d = L[j][j];
  const float mine = __frcp_rn(d);
  S6DivRecip div;
#pragma unroll
  for (int j = 0; j < 6; ++j) div.r[j] = __shfl_sync(HS_FULL_MASK, mine, j);

  // z = (A + lam I)^-1 b, then x = (A + lam I)^-1 A z
  float z[6], az[6], x[6];
  hs_chol_solve6(L, b, z, div);
  hs_matvec6(a, z, az);
  hs_chol_solve6(L, az, x, div);
  hs_twist_compose<true>(x, ok, pose, max_step, res);
  if (lane == 0) {
#pragma unroll
    for (int i = 0; i < 17; ++i) out[i] = res[i];
  }
}

// a: the (6, 6) A, b: the (6,) b, pose: the (4, 4) pose, each contiguous
// float32 on the card; out: 17 floats (the new pose, the step norm).
extern "C" int hs_solve6(const float* a, const float* b, const float* pose, float* out,
                         float damping, float max_step, void* stream) {
  solve6_kernel<<<1, S6_LANES, 0, (cudaStream_t)stream>>>(a, b, pose, out, damping, max_step);
  return (int)cudaGetLastError();
}

// Resident blocks an SM: out[0] the one-warp solve.
extern "C" int hs_solve6_occupancy(int, int* out) {
  return hs_occupancy(solve6_kernel, S6_LANES, 0, out);
}
