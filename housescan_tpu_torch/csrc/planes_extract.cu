// K7: the whole-volume sub-block plane extraction (replaces
// housescan_tpu/ops/planes_pallas.py _kernel, line 372, called at :405 by
// extract_subblock_planes). See housescan_tpu_torch/ops/planes_cuda.py for
// the plain version and the design note.
//
// One block of 512 threads per (8, 8, 128) chunk, over every chunk of the
// volume. The block loads the chunk's tsdf and weight (either layout,
// through the store of common.cuh: a packed cell is decoded) into 64 KB of
// dynamic shared memory, coalesced along z, then warp s fits sub-block s
// with the device fit of planes.cuh that K4 inlines. Unlike K4's refit it
// writes every field of every chunk, also where no plane can be valid;
// field 11 stays 0.
//
// Bound: device-memory bytes. Each voxel is read once (float32: 8 bytes,
// packed: 4) and each chunk's (16, 16) planes tile written once; the fit
// is ~40 float operations a voxel (three crossing tests and their moment
// terms, the band terms), far below the card's float rate at this
// traffic.
#include "planes.cuh"

#define PE_THREADS 512
#define PE_VOX 8192

// p: voxel size, origin x, y, z, min_count, nbx (the sub-block ids' x
// stride in chunks)
template <class Store>
__global__ void __launch_bounds__(PE_THREADS)
planes_extract_kernel(Store vol, float* __restrict__ planes, int ny, int nz,
                      const float* __restrict__ p) {
  extern __shared__ float s_tw[];  // [0, 8192): tsdf, [8192, 16384): weight
  float* s_t = s_tw;
  float* s_w = s_tw + PE_VOX;
  __shared__ float s_fields[HS_N_FIELDS][HS_NSUB];
  const int nby = ny / 8, nzc = nz / 128;
  const int chunk = blockIdx.x;
  const int ci = chunk / (nby * nzc), cj = (chunk / nzc) % nby, ck = chunk % nzc;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int z = tid & 127;

  for (int k = 0; k < 16; ++k) {
    const int xy = (tid >> 7) + 4 * k;
    const int ix = xy >> 3, iy = xy & 7;
    const size_t addr = ((size_t)(ci * 8 + ix) * ny + (cj * 8 + iy)) * nz + (size_t)ck * 128 + z;
    float t, w;
    vol.load(addr, t, w);
    s_t[xy * 128 + z] = t;
    s_w[xy * 128 + z] = w;
  }
  if (tid < HS_N_FIELDS * HS_NSUB) s_fields[tid >> 4][tid & 15] = 0.0f;
  __syncthreads();

  HsFitGeom g;
  g.ci = ci;
  g.cj = cj;
  g.z_base = (float)(ck * 128);
  g.sid_base = (((long long)ci * (int)p[5] + cj) * nzc + ck) * HS_NSUB;
  g.vs = p[0];
  g.ox = p[1];
  g.oy = p[2];
  g.oz = p[3];
  g.min_count = p[4];
  hs_fit_subblock_warp(HsSmemChunk{s_t, s_w, 128}, warp, lane, 127, g, (float)warp, s_fields);
  __syncthreads();
  if (tid < HS_N_FIELDS * HS_NSUB)
    planes[(size_t)chunk * HS_N_FIELDS * HS_NSUB + tid] = s_fields[tid >> 4][tid & 15];
}

template <class Store>
static int pe_launch(Store vol, float* planes, int n_chunks, int ny, int nz, const float* params,
                     cudaStream_t stream) {
  const int smem = 2 * PE_VOX * (int)sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(planes_extract_kernel<Store>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  planes_extract_kernel<Store><<<n_chunks, PE_THREADS, smem, stream>>>(vol, planes, ny, nz,
                                                                       params);
  return (int)cudaGetLastError();
}

// layout: HS_LAYOUT_PACKED (vol is the (nx, ny, nz) int32 grid) or
// HS_LAYOUT_F32 (vol is the (2, nx, ny, nz) float32 array); planes is the
// (nx / 8, ny / 8, nz / 128, 16, 16) output.
extern "C" int hs_planes_extract(void* vol, int layout, float* planes, int nx, int ny, int nz,
                                 const float* params, void* stream) {
  const int n_chunks = (nx / 8) * (ny / 8) * (nz / 128);
  if (n_chunks <= 0) return 0;
  const cudaStream_t st = (cudaStream_t)stream;
  if (layout == HS_LAYOUT_PACKED)
    return pe_launch(HsPacked{(int*)vol}, planes, n_chunks, ny, nz, params, st);
  if (layout == HS_LAYOUT_F32)
    return pe_launch(HsPlanar<float>{(float*)vol, (size_t)nx * ny * nz}, planes, n_chunks, ny, nz,
                     params, st);
  return (int)cudaErrorInvalidValue;
}

// Resident blocks an SM: out[0] packed, out[1] float32.
extern "C" int hs_planes_extract_occupancy(int, int* out) {
  const int smem = 2 * PE_VOX * (int)sizeof(float);
  const int e = hs_occupancy(planes_extract_kernel<HsPacked>, PE_THREADS, smem, out);
  return e ? e : hs_occupancy(planes_extract_kernel<HsPlanar<float>>, PE_THREADS, smem, out + 1);
}
