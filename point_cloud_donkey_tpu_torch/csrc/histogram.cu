// K9: batched weighted histograms, H[r, b] = sum_c w[r, c] [idx[r, c] = b].
//
// Replaces point_cloud_donkey_tpu/ops/pallas/histogram.py `_hist_kernel`
// (`batched_histogram`), the function of ops/shot.py
// `_histogram_from_slots` that the SHORT_SHOT descriptor accumulates its
// slots with (R = keypoints, C = points x 4 slots, L = 32 bins).  As in the
// masked reduction of the TPU kernel, an index outside [0, L) adds nothing.
//
// What bounds it on the H100: the bytes of its inputs.  At the SHORT_SHOT
// step's shapes (R = 24576 rows, C = 8192) idx and w are 1.6 GB, read once:
// ~0.48 ms at 3.35 TB/s; only ~10% of the entries carry a weight.
// Design: the TPU kernel loops over the L bins with a masked lane reduction
// over the whole [TR, C] tile each time (O(R C L) work).  Here one warp per
// row, eight rows per CTA, each warp with its row's [L] f32 histogram in
// shared memory.  The lanes read 32 consecutive weights at a time
// (coalesced), a ballot finds the nonzero ones, only those lanes read their
// index, and the live entries are added one at a time in column order by
// plain read-modify-writes: no atomics, one fixed summation order, the same
// bits on every run.  The histogram is written out once.
#include "common.cuh"

namespace {

constexpr int ROWS = 8;      // rows (warps) per CTA
constexpr int THREADS = ROWS * 32;

__global__ void __launch_bounds__(THREADS)
histogram_kernel(const int* __restrict__ idx, const float* __restrict__ w,
                 float* __restrict__ out, int R, int C, int L) {
  extern __shared__ float hist_smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  float* h = hist_smem + warp * L;
  const int row = blockIdx.x * ROWS + warp;
  if (row >= R) return;  // whole warps only: no CTA-wide barrier below
  for (int i = lane; i < L; i += 32) h[i] = 0.f;
  __syncwarp();

  const size_t base = (size_t)row * C;
  for (int c0 = 0; c0 < C; c0 += 32) {
    const int c = c0 + lane;
    const float wv = c < C ? w[base + c] : 0.f;
    const bool live = wv != 0.f;
    unsigned todo = __ballot_sync(0xffffffffu, live);
    if (todo == 0u) continue;
    const int b = live ? idx[base + c] : -1;
    while (todo) {
      const int j = __ffs(todo) - 1;
      todo &= todo - 1u;
      if (lane == j && (unsigned)b < (unsigned)L) h[b] += wv;
      __syncwarp();
    }
  }
  float* o = out + (size_t)row * L;
  for (int i = lane; i < L; i += 32) o[i] = h[i];
}

}  // namespace

// idx [R, C] i32, w [R, C] f32 -> out [R, L] f32; every element is written.
PCD_EXPORT int pcd_histogram(const void* idx, const void* w, void* out, int R,
                             int C, int L, void* stream) {
  if (R == 0) return pcd_last_error();
  const size_t smem = (size_t)ROWS * L * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        histogram_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  histogram_kernel<<<(R + ROWS - 1) / ROWS, THREADS, smem,
                     (cudaStream_t)stream>>>((const int*)idx, (const float*)w,
                                             (float*)out, R, C, L);
  return pcd_last_error();
}
