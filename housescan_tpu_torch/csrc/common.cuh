// Shared helpers of the housescan_tpu_torch kernels.
//
// The library builds with --fmad=false: every float multiply and add is
// rounded separately, as in the plain PyTorch versions, so the kernels
// repeat those versions' arithmetic operation for operation.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define HS_FULL_MASK 0xffffffffu

// max(x, lo) / min(x, hi) that keep a NaN x, as torch.clamp does.
__device__ __forceinline__ float hs_clamp_min(float x, float lo) { return x < lo ? lo : x; }
__device__ __forceinline__ float hs_clamp_max(float x, float hi) { return x > hi ? hi : x; }

// Packed volume cell: tsdf quantized to [-32767, 32767] in the high half,
// integer weight in the low half (housescan_tpu_torch/kinfu/tsdf.py).
__device__ __forceinline__ float hs_unpack_t(int v) {
  return (float)(v >> 16) * (float)(1.0 / 32767.0);
}
__device__ __forceinline__ float hs_unpack_w(int v) { return (float)(v & 0xFFFF); }
__device__ __forceinline__ int hs_pack(float t, float w) {
  float tc = hs_clamp_max(hs_clamp_min(t, -1.0f), 1.0f);
  int ti = (int)rintf(tc * 32767.0f);  // rintf rounds half to even, as torch.round
  return (int)(((unsigned)ti << 16) | (unsigned)(int)w);
}
