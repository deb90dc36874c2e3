// K8: the two-pass SHOT / CSHOT histogram from compact slot arrays.
//
// Replaces point_cloud_donkey_tpu/ops/pallas/shot_hist.py `_hist_call`
// (`shot_histogram_pallas`), the Pallas form of ops/shot.py
// `_shot_histogram_2pass`.  For every row r (a keypoint) and column m (a
// point), with V = 32 volumes and n_bin bins per volume (11 for SHOT and
// CSHOT's shape channel, 31 for CSHOT's colour channel):
//   pass A: H[desc, step] += central_w,  H[desc, cos_bin] += cos_w
//   pass B: H[rad_vol, step] += rad_w,   H[incl_vol, step] += incl_w,
//           H[az_vol, step] += az_w
// which is onehot(desc) x (onehot(step) cw + onehot(cos_bin) cos_w) plus
// (onehot(rad) rw + onehot(incl) iw + onehot(az) aw) x onehot(step).  As in
// the one-hot products, an index outside [0, V) or [0, n_bin) adds nothing.
// The caller zero-weights masked lanes.
//
// What bounds it on the H100: the bytes of its inputs.  At the CSHOT step's
// shapes (R = 128 clouds x 192 keypoints = 24576 rows, M = 2048 points) the
// eleven [R, M] arrays are 2.2 GB, read once: ~0.66 ms at 3.35 TB/s, while
// only the ~16% of columns inside the descriptor radius carry a weight
// (five adds each).
// Design: the TPU kernel builds [TM, V] / [TM, n_bin] one-hots in VMEM and
// contracts them on the MXU per keypoint; on Hopper nothing one-hot exists.
// One warp per row, eight rows per CTA; each warp owns its row's [V * n_bin]
// f32 histogram in shared memory (3968 B at n_bin 31).  The lanes read 32
// consecutive columns of the five weight arrays at a time (coalesced); a
// ballot finds the live columns, only those lanes read the six index arrays,
// and the live columns then add their five slots one column at a time, in
// column order, by plain read-modify-writes: no atomics, so the sums have
// one fixed order and the same bits on every run, and the five slots of a
// column may hit the same bin.  The histogram is written out once.
#include "common.cuh"

namespace {

constexpr int V = 32;        // spatial volumes
constexpr int ROWS = 8;      // rows (warps) per CTA
constexpr int THREADS = ROWS * 32;

__device__ __forceinline__ void add_slot(float* __restrict__ h, int vol,
                                         int bin, float w, int n_bin) {
  if (w != 0.f && (unsigned)vol < (unsigned)V && (unsigned)bin < (unsigned)n_bin)
    h[vol * n_bin + bin] += w;
}

__global__ void __launch_bounds__(THREADS)
shot_hist_kernel(const int* __restrict__ desc, const int* __restrict__ step,
                 const float* __restrict__ central_w,
                 const int* __restrict__ cos_bin,
                 const float* __restrict__ cos_w,
                 const int* __restrict__ rad_vol,
                 const float* __restrict__ rad_w,
                 const int* __restrict__ incl_vol,
                 const float* __restrict__ incl_w,
                 const int* __restrict__ az_vol,
                 const float* __restrict__ az_w, float* __restrict__ out,
                 int R, int M, int n_bin) {
  extern __shared__ float hist_smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int len = V * n_bin;
  float* h = hist_smem + warp * len;
  const int row = blockIdx.x * ROWS + warp;
  if (row >= R) return;  // whole warps only: no CTA-wide barrier below
  for (int i = lane; i < len; i += 32) h[i] = 0.f;
  __syncwarp();

  const size_t base = (size_t)row * M;
  for (int m0 = 0; m0 < M; m0 += 32) {
    const int m = m0 + lane;
    float w0 = 0.f, w1 = 0.f, w2 = 0.f, w3 = 0.f, w4 = 0.f;
    if (m < M) {
      w0 = central_w[base + m];
      w1 = cos_w[base + m];
      w2 = rad_w[base + m];
      w3 = incl_w[base + m];
      w4 = az_w[base + m];
    }
    const bool live =
        (w0 != 0.f) | (w1 != 0.f) | (w2 != 0.f) | (w3 != 0.f) | (w4 != 0.f);
    unsigned todo = __ballot_sync(0xffffffffu, live);
    if (todo == 0u) continue;
    int d = 0, s = 0, cb = 0, rv = 0, iv = 0, av = 0;
    if (live) {
      d = desc[base + m];
      s = step[base + m];
      cb = cos_bin[base + m];
      rv = rad_vol[base + m];
      iv = incl_vol[base + m];
      av = az_vol[base + m];
    }
    while (todo) {
      const int j = __ffs(todo) - 1;
      todo &= todo - 1u;
      if (lane == j) {
        add_slot(h, d, s, w0, n_bin);
        add_slot(h, d, cb, w1, n_bin);
        add_slot(h, rv, s, w2, n_bin);
        add_slot(h, iv, s, w3, n_bin);
        add_slot(h, av, s, w4, n_bin);
      }
      __syncwarp();
    }
  }
  float* o = out + (size_t)row * len;
  for (int i = lane; i < len; i += 32) o[i] = h[i];
}

}  // namespace

// desc, step, cos_bin, rad_vol, incl_vol, az_vol [R, M] i32; central_w,
// cos_w, rad_w, incl_w, az_w [R, M] f32 -> out [R, 32 * n_bin] f32
// (volume-major); every output element is written.
PCD_EXPORT int pcd_shot_hist(const void* desc, const void* step,
                             const void* central_w, const void* cos_bin,
                             const void* cos_w, const void* rad_vol,
                             const void* rad_w, const void* incl_vol,
                             const void* incl_w, const void* az_vol,
                             const void* az_w, void* out, int R, int M,
                             int n_bin, void* stream) {
  if (R == 0) return pcd_last_error();
  const size_t smem = (size_t)ROWS * V * n_bin * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        shot_hist_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  shot_hist_kernel<<<(R + ROWS - 1) / ROWS, THREADS, smem,
                     (cudaStream_t)stream>>>(
      (const int*)desc, (const int*)step, (const float*)central_w,
      (const int*)cos_bin, (const float*)cos_w, (const int*)rad_vol,
      (const float*)rad_w, (const int*)incl_vol, (const float*)incl_w,
      (const int*)az_vol, (const float*)az_w, (float*)out, R, M, n_bin);
  return pcd_last_error();
}
