// K5: the pure-free carve of the streaming TSDF integrate (replaces
// housescan_tpu/ops/tsdf_stream.py _free_kernel, called from
// tsdf_integrate_stream with free_split=True). See
// housescan_tpu_torch/ops/tsdf_stream.py for the plain version
// (free_carve_plain) and ops/chunk_select.py for the free work list.
//
// Grid (n_sb, 16): block (e, s) takes member slot s = qi * 4 + qj of
// free-list entry e, i.e. chunk (4 bi + qi, 4 bj + qj, bk). A block at or
// past the device-side count, or on a clear member bit, returns at once:
// the host never reads the count, and a non-member chunk is never
// touched (the TPU kernel copies it through unchanged, which on the GPU
// is leaving it alone).
//
// Bound: device-memory bytes. Each member chunk's 8192 voxels are read
// once and written once (packed: 32 KB each way; float32: 64 KB) and its
// (16, 16) planes tile is written (1 KB); the arithmetic is ~30 float operations per voxel. The
// design keeps the work to exactly those bytes: one block per member
// chunk, every voxel loaded and stored once, coalesced along z, and the
// per-quarter flag reductions in registers and shared memory.
//
// Thread t owns z = t % 128 and the 16 voxels (ix, iy) with
// ix * 8 + iy = t / 128 + 4 k, so warp w covers 32 consecutive z of one
// z-quarter (w % 4), as in csrc/tsdf_stream.cu. Per voxel, the CLS_FREE
// carve of the reference verbatim: the in-view test multiplied through by
// zc, wnew = min(wold + wadd, max_weight), tnew = (told wold + wadd) /
// max(wold + wadd, 1), the store of the volume's layout (common.cuh: the
// packed write rounds half to even; float32 stores as is). Per
// z-quarter, min observed t, min observed w and max w (min/max: exact in
// any order) give the saturation flag; the tile is zeros with the four
// flags in field 11, columns 0-3. Eligibility (no observed negative tsdf
// in a member chunk) means the carve creates no zero crossing, so this is
// the tile K4 writes on its no-crossing branch.
#include "common.cuh"

#define TF_THREADS 512
#define TF_TILE 256  // (N_FIELDS, NSUB_C) = (16, 16) planes tile of a chunk
#define TF_BIG 1.0e9f

template <class Store>
__global__ void __launch_bounds__(TF_THREADS)
tsdf_free_kernel(Store vol, float* __restrict__ planes,
                 const int* __restrict__ bitmap, const int* __restrict__ count,
                 const int* __restrict__ bi, const int* __restrict__ bj,
                 const int* __restrict__ bk, int ny, int nz, const float* __restrict__ p,
                 float sat_w) {
  const int e = blockIdx.x, slot = blockIdx.y;
  if (e >= *count) return;
  if (((bitmap[e] >> slot) & 1) == 0) return;
  const int ci = bi[e] * 4 + (slot >> 2), cj = bj[e] * 4 + (slot & 3), ck = bk[e];

  __shared__ float s_red[3][TF_THREADS / 32];
  __shared__ float s_sat[4];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int z = tid & 127;

  const float r00 = p[0], r01 = p[1], r02 = p[2], r10 = p[3], r11 = p[4], r12 = p[5];
  const float r20 = p[6], r21 = p[7], r22 = p[8];
  const float tx = p[9], ty = p[10], tz = p[11];
  const float fx = p[12], fy = p[13], cx = p[14], cy = p[15];
  const float vs = p[17], ox = p[18], oy = p[19], oz = p[20];
  const float max_weight = p[21], img_w = p[22], img_h = p[23];
  const float zw = oz + ((float)(ck * 128) + (float)z + 0.5f) * vs;

  float mn_t = 1.0f, mn_w = TF_BIG, mx_w = -1.0f;
  for (int k = 0; k < 16; ++k) {
    const int xy = (tid >> 7) + 4 * k;
    const int ix = xy >> 3, iy = xy & 7;
    const size_t addr = ((size_t)(ci * 8 + ix) * ny + (cj * 8 + iy)) * nz + (size_t)ck * 128 + z;
    float told, wold;
    vol.load(addr, told, wold);
    const float xw = ox + ((float)(ci * 8) + (float)ix + 0.5f) * vs;
    const float yw = oy + ((float)(cj * 8) + (float)iy + 0.5f) * vs;
    const float dx = xw - tx, dy = yw - ty, dz = zw - tz;
    const float xc = dx * r00 + dy * r01 + dz * r02;
    const float yc = dx * r10 + dy * r11 + dz * r12;
    const float zc = dx * r20 + dy * r21 + dz * r22;
    const float fxx = fx * xc, fyy = fy * yc;
    const bool iv = (zc > 1e-6f) && (fxx >= -cx * zc) && (fxx <= (img_w - 1.0f - cx) * zc) &&
                    (fyy >= -cy * zc) && (fyy <= (img_h - 1.0f - cy) * zc);
    const float wadd = iv ? 1.0f : 0.0f;
    const float wnew = fminf(wold + wadd, max_weight);
    const float denom = hs_clamp_min(wold + wadd, 1.0f);
    const float tnew = (told * wold + wadd) / denom;
    const float tcur = iv ? tnew : told;
    vol.store(addr, tcur, wnew);
    const bool obs = wnew > 0.0f;
    mn_t = fminf(mn_t, obs ? tcur : 1.0f);
    mn_w = fminf(mn_w, obs ? wnew : TF_BIG);
    mx_w = fmaxf(mx_w, wnew);
  }

  mn_t = hs_warp_min(mn_t);
  mn_w = hs_warp_min(mn_w);
  mx_w = hs_warp_max(mx_w);
  if (lane == 0) {
    s_red[0][warp] = mn_t;
    s_red[1][warp] = mn_w;
    s_red[2][warp] = mx_w;
  }
  __syncthreads();
  if (tid < 4) {  // quarter q: warps q, q + 4, q + 8, q + 12
    float mint = 1.0f, minw = TF_BIG, maxw = -1.0f;
    for (int w8 = tid; w8 < TF_THREADS / 32; w8 += 4) {
      mint = fminf(mint, s_red[0][w8]);
      minw = fminf(minw, s_red[1][w8]);
      maxw = fmaxf(maxw, s_red[2][w8]);
    }
    s_sat[tid] = (minw >= sat_w && mint > 0.999f && maxw > 0.0f) ? 1.0f : 0.0f;
  }
  __syncthreads();
  if (tid < TF_TILE) {
    const int f = tid >> 4, col = tid & 15;
    const size_t chunk = ((size_t)ci * (ny / 8) + cj) * (nz / 128) + ck;
    planes[chunk * TF_TILE + tid] = (f == 11 && col < 4) ? s_sat[col] : 0.0f;
  }
}

// layout: HS_LAYOUT_PACKED (vol is the (nx, ny, nz) int32 grid) or
// HS_LAYOUT_F32 (vol is the (2, nx, ny, nz) float32 array).
extern "C" int hs_tsdf_free(void* vol, int layout, float* planes, const int* bitmap,
                            const int* count, const int* bi, const int* bj, const int* bk,
                            int n_sb, int nx, int ny, int nz, const float* params, float sat_w,
                            void* stream) {
  if (n_sb <= 0) return 0;
  dim3 grid(n_sb, 16);
  const cudaStream_t st = (cudaStream_t)stream;
  if (layout == HS_LAYOUT_PACKED)
    tsdf_free_kernel<<<grid, TF_THREADS, 0, st>>>(HsPacked{(int*)vol}, planes, bitmap, count, bi,
                                                  bj, bk, ny, nz, params, sat_w);
  else if (layout == HS_LAYOUT_F32)
    tsdf_free_kernel<<<grid, TF_THREADS, 0, st>>>(
        HsPlanar<float>{(float*)vol, (size_t)nx * ny * nz}, planes, bitmap, count, bi, bj, bk,
        ny, nz, params, sat_w);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// Resident blocks an SM: out[0] packed, out[1] float32.
extern "C" int hs_tsdf_free_occupancy(int, int* out) {
  const int e = hs_occupancy(tsdf_free_kernel<HsPacked>, TF_THREADS, 0, out);
  return e ? e : hs_occupancy(tsdf_free_kernel<HsPlanar<float>>, TF_THREADS, 0, out + 1);
}
