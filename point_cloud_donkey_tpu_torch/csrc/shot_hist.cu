// K8: CSHOT-1344 histograms over the dense [B, K] keypoint grid, the pairs
// binned on chip.
//
// Replaces point_cloud_donkey_tpu/ops/pallas/shot_hist.py `_hist_call`
// (`shot_histogram_pallas`), the Pallas form of ops/shot.py
// `_shot_histogram_2pass`, with the slot math in front of it fused in: the
// JAX package's CSHOT builds eleven [K, N] slot arrays per channel
// (`_cshot_core_from_coords`) and accumulates them with the two-pass
// histogram; XLA fuses that glue on the TPU.  Here no slot array exists.
// For every live row (keypoint q of cloud b, a valid frame) and every point
// p of cloud b with 1e-15 < |p - q|^2 <= r^2, the mask set and a finite
// normal: the local-frame coordinates (p - q) . axis, the cosine between
// the normal and the frame's z axis, and the normalised-Lab colour
// distance (|dL| + (|da| + |db|) / 2) / 3 clamped to [0, 1]; the pair's
// spatial half is binned once and soft-binned twice (shot_slots.cuh): the
// shape channel's five slots into [0, 352), the colour channel's five into
// [352, 1344).  The raw histogram and the in-radius count are written out
// once; rows that are not live come out zero.  The wrapper normalises.
//
// What bounds it on the H100: arithmetic on the in-radius pairs.  At the
// CSHOT step's shapes (128 clouds x 192 keypoints x 2048 points) ~55% of
// the grid's rows are live and ~16% of their pairs lie within r = 0.6; an
// in-radius pair costs ~130 fp32 operations with sqrtf, acosf and atan2f
// and ten histogram adds.  The output, [24576, 1344] f32, is 132 MB.
// Design: pairs::sweep (radius_pairs.cuh), as K3: one CTA per 8 keypoints
// of one cloud, one warp per keypoint, the cloud staged 512 points at a
// time (x, y, z, the normal and the three Lab floats: 18 KB), in-radius
// points queued by ballots and binned 32 at a time on full warps.  Each
// warp owns its keypoint's [1344] histogram in shared memory (8 x 5376 B =
// 43 KB a CTA; 65 KB with the staged chunk and the queues, so three CTAs
// share an SM's 228 KB).  The ten slots of a batch enter it in slot order,
// each by pairs::warp_add (equal-bin lanes summed in lane order): two
// launches give equal bits.  A CTA with no live row writes its zeros and
// exits (~45% of the serving grid is padding).
#include "common.cuh"
#include "radius_pairs.cuh"
#include "shot_slots.cuh"

namespace {

using pairs::THREADS;
using pairs::TK;
using shot::CDESC;
using shot::DESC;
using shot::SLOTS;

constexpr int CH = 512;    // points staged per chunk
constexpr int NF = 9;      // x, y, z, normal, Lab
constexpr float THIRD = 1.0f / 3.0f;

struct CshotSmem {
  pairs::Staged<CH, NF> st;
  float h[TK][CDESC];      // warp k's histogram, shape channel first
};

// Grid: B * tiles CTAs; CTA (b, t) describes rows b*K + t*8 + k, k < 8,
// t*8 + k < K.
__global__ void __launch_bounds__(THREADS, 3)
cshot_hist_kernel(const float* __restrict__ kp,
                  const float* __restrict__ kp_lab,
                  const float* __restrict__ fr,
                  const unsigned char* __restrict__ live,
                  const float* __restrict__ points,
                  const float* __restrict__ normals,
                  const float* __restrict__ lab,
                  const unsigned char* __restrict__ mask,
                  float* __restrict__ hist, int* __restrict__ count, int K,
                  int N, int tiles, float rad) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  CshotSmem& sm = *reinterpret_cast<CshotSmem*>(smem_raw);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int b = blockIdx.x / tiles;
  const int k = (blockIdx.x % tiles) * TK + warp;
  const bool row_ok = k < K;
  const size_t row = (size_t)b * K + k;
  const bool on = row_ok && live[row];
  float* out = hist + row * CDESC;
  if (!__syncthreads_or(on)) {   // uniform over the CTA
    if (row_ok) {
      for (int e = lane; e < CDESC; e += 32) out[e] = 0.f;
      if (lane == 0) count[row] = 0;
    }
    return;
  }
  const float r2 = rad * rad;
  const float r_half = rad / 2.0f;
  const float r34 = 3.0f * rad / 4.0f;
  const float r14 = rad / 4.0f;
  float f[15] = {};   // frame rows x, y, z (9), keypoint (3), Lab (3)
  if (on) {
#pragma unroll
    for (int c = 0; c < 9; ++c) f[c] = fr[row * 9 + c];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      f[9 + c] = kp[row * 3 + c];
      f[12 + c] = kp_lab[row * 3 + c];
    }
  }
  float* h = sm.h[warp];
  for (int e = lane; e < CDESC; e += 32) h[e] = 0.f;

  const size_t base = (size_t)b * N;
  const float* const src[3] = {points + base * 3, normals + base * 3,
                               lab + base * 3};
  const float (&v)[NF][CH] = sm.st.v;
  // bin one batch: lane l holds staged point j (when act); the shape
  // channel's five slots, then the colour channel's, each by warp_add
  auto bin_batch = [&](int j, bool act) {
    shot::Slots s[2];
    if (act) {
      const float dx = v[0][j] - f[9], dy = v[1][j] - f[10],
                  dz = v[2][j] - f[11];
      const float d2 = dx * dx + dy * dy + dz * dz;
      const float x_l = dx * f[0] + dy * f[1] + dz * f[2];
      const float y_l = dx * f[3] + dy * f[4] + dz * f[5];
      const float z_l = dx * f[6] + dy * f[7] + dz * f[8];
      const float cos_desc = fminf(
          fmaxf(v[3][j] * f[6] + v[4][j] * f[7] + v[5][j] * f[8], -1.0f),
          1.0f);
      // ops/color.py color_distance: keypoint minus point, clamped to
      // [0, 1] with NaN kept (torch.clamp)
      const float dl = fabsf(f[12] - v[6][j]), da = fabsf(f[13] - v[7][j]),
                  db = fabsf(f[14] - v[8][j]);
      float cdist = (dl + (da + db) * 0.5f) * THIRD;
      cdist = cdist < 0.f ? 0.f : (cdist > 1.f ? 1.f : cdist);
      const shot::Spatial sp =
          shot::shot_spatial(x_l, y_l, z_l, sqrtf(d2), r_half, r34, r14);
      s[0] = shot::shot_channel(sp, (1.0f + cos_desc) * (shot::NR_BINS / 2.0f),
                                shot::NR_BINS);
      s[1] = shot::shot_channel(sp, cdist * (float)shot::NR_COLOR_BINS,
                                shot::NR_COLOR_BINS);
    } else {
#pragma unroll
      for (int i = 0; i < SLOTS; ++i) {
        s[0].idx[i] = s[1].idx[i] = -1;
        s[0].w[i] = s[1].w[i] = 0.f;
      }
    }
#pragma unroll
    for (int c = 0; c < 2; ++c)
#pragma unroll
      for (int i = 0; i < SLOTS; ++i)
        pairs::warp_add(c ? h + DESC : h, s[c].idx[i], s[c].w[i]);
  };
  const int cnt = pairs::sweep<CH, NF, true>(sm.st, src, mask + base, N, on,
                                             f[9], f[10], f[11], r2,
                                             bin_batch);
  __syncwarp();
  if (row_ok) {
    for (int e = lane; e < CDESC; e += 32) out[e] = h[e];
    if (lane == 0) count[row] = cnt;
  }
}

}  // namespace

// kp, kp_lab [B*K, 3], frames [B*K, 9] (rows x, y, z axes), live [B*K] u8
// (rows to describe), points / normals / lab [B, N, 3] f32, mask [B, N] u8
// -> hist [B*K, 1344] f32 (raw, shape channel first, volume-major), count
// [B*K] i32; every element is written.
PCD_EXPORT int pcd_cshot_hist(const void* kp, const void* kp_lab,
                              const void* frames, const void* live,
                              const void* points, const void* normals,
                              const void* lab, const void* mask, void* hist,
                              void* count, int B, int K, int N, float r,
                              void* stream) {
  const int tiles = (K + TK - 1) / TK;
  if (B == 0 || tiles == 0) return pcd_last_error();
  const int smem = (int)sizeof(CshotSmem);
  int dev = 0;
  cudaGetDevice(&dev);
  static bool smem_set[64] = {};
  if (dev >= 64 || !smem_set[dev]) {
    const cudaError_t e = cudaFuncSetAttribute(
        cshot_hist_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    if (dev < 64) smem_set[dev] = true;
  }
  cshot_hist_kernel<<<B * tiles, THREADS, smem, (cudaStream_t)stream>>>(
      (const float*)kp, (const float*)kp_lab, (const float*)frames,
      (const unsigned char*)live, (const float*)points,
      (const float*)normals, (const float*)lab, (const unsigned char*)mask,
      (float*)hist, (int*)count, K, N, tiles, r);
  return pcd_last_error();
}
