// K9: SHORT_SHOT histograms over the dense [B, K] keypoint grid, the pairs
// binned on chip.
//
// Replaces point_cloud_donkey_tpu/ops/pallas/histogram.py `_hist_kernel`
// (`batched_histogram`), the function of ops/shot.py `_histogram_from_slots`
// that the JAX SHORT_SHOT accumulates its four [K, N] slot arrays with,
// with the slot math of `_short_shot_core` in front of it fused in; XLA
// fuses that glue on the TPU.  Here no slot array exists.  For every live
// row (keypoint q of cloud b, a valid frame) and every point p of cloud b
// with 1e-15 < |p - q|^2 <= r^2 and the mask set: the local-frame
// coordinates (x, y, z) = (p - q) . axis, r = |(x, y, z)|, theta =
// degrees(acos(z / r)), phi = degrees(atan2(y, x)), truncated bins and
// per-axis linear interpolation into one secondary bin each (cyclic in
// phi), as ops/short_shot.py `_short_shot_slots` computes them, float
// operation for float operation: four (bin, weight) slots of the
// r_bins x e_bins x a_bins = D <= 256 grid.  With a minimum radius
// (min_r > 0) a pair with r < min_r adds nothing; with the log radius the
// radial coordinate is (r_bins - 1) (ln max(r, 1e-30) - ln_rmin) / ln_span
// + 1 (features_short_shot.cpp:125-160; ln_rmin and ln_span computed in
// double on the host and rounded to float, as the JAX package does).  The raw histogram is written
// out once; rows that are not live come out zero.  The wrapper normalises.
//
// What bounds it on the H100: arithmetic on the in-radius pairs (~16% of a
// live row's pairs at the serving radius; ~150 fp32 operations each with
// sqrtf, acosf, atan2f and three IEEE divisions, and four adds).  The
// output at the serving shapes, [24576, 32] f32, is 3 MB.
// Design: pairs::sweep (radius_pairs.cuh), as K3 and K8: one CTA per 8
// keypoints of one cloud, one warp per keypoint, the cloud's masked-in
// points staged 1024 at a time (x, y, z: 12 KB), in-radius points queued by
// ballots and binned 32 at a time on full warps.  The histogram lives in
// registers: lane l owns bins l, l + 32, ... (NQ = ceil(D / 32) of them).
// After a batch's 32 lanes have made their slots, the pairs are walked in
// order and each slot reaches its bin's owner by two shuffles (bin,
// weight): every bin adds its weights in (point, slot) order -- the order
// of the plain twin's index_add_ -- with no shared histogram and no
// atomics, so two launches give equal bits.  A CTA with no live row writes
// its zeros and exits.
#include "common.cuh"
#include "radius_pairs.cuh"

namespace {

using pairs::FULL;
using pairs::THREADS;
using pairs::TK;

constexpr int CH = 1024;   // points staged per chunk (x, y, z)
constexpr int MAX_NQ = 8;  // D <= 256 bins: 8 registers a lane
constexpr float RAD2DEG = (float)(180.0 / 3.14159265358979323846);

// features_short_shot.cpp linear_interpolation: the primary weight and
// the secondary offset (-1 / +1) of a raw bin coordinate
__device__ __forceinline__ float interp(float raw, int& off) {
  const float dec = raw - floorf(raw);
  off = dec <= 0.5f ? -1 : 1;
  return dec <= 0.5f ? dec + 0.5f : (1.0f - dec) + 0.5f;
}

__device__ __forceinline__ int clamp_bin(int b, int total) {
  return b < 0 ? 0 : (b > total - 1 ? total - 1 : b);
}

template <int NQ>
__global__ void __launch_bounds__(THREADS, 4)
short_shot_hist_kernel(const float* __restrict__ kp,
                       const float* __restrict__ fr,
                       const unsigned char* __restrict__ live,
                       const float* __restrict__ points,
                       const unsigned char* __restrict__ mask,
                       float* __restrict__ hist, int K, int N, int tiles,
                       float rad, int r_bins, int e_bins, int a_bins,
                       float min_r, int log_r, float ln_rmin,
                       float ln_span) {
  __shared__ pairs::Staged<CH, 3> st;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int D = r_bins * e_bins * a_bins;
  const int b = blockIdx.x / tiles;
  const int k = (blockIdx.x % tiles) * TK + warp;
  const bool row_ok = k < K;
  const size_t row = (size_t)b * K + k;
  const bool on = row_ok && live[row];
  float* out = hist + row * D;
  float acc[NQ];
#pragma unroll
  for (int q = 0; q < NQ; ++q) acc[q] = 0.f;
  if (__syncthreads_or(on)) {   // uniform over the CTA
    float f[12] = {};   // frame rows x, y, z (9) + keypoint (3)
    if (on) {
#pragma unroll
      for (int c = 0; c < 9; ++c) f[c] = fr[row * 9 + c];
#pragma unroll
      for (int c = 0; c < 3; ++c) f[9 + c] = kp[row * 3 + c];
    }
    const float r_r = (float)r_bins, r_e = (float)e_bins, r_a = (float)a_bins;
    const float* const src[1] = {points + (size_t)b * N * 3};
    // bin one batch: each active lane makes its pair's four slots (bin, or
    // -1 for a slot that adds nothing), then the pairs are walked in order
    auto bin_batch = [&](int j, bool act) {
      int bin[4] = {-1, -1, -1, -1};
      float w[4] = {0.f, 0.f, 0.f, 0.f};
      if (act) {
        const float dx = st.v[0][j] - f[9], dy = st.v[1][j] - f[10],
                    dz = st.v[2][j] - f[11];
        const float x_l = dx * f[0] + dy * f[1] + dz * f[2];
        const float y_l = dx * f[3] + dy * f[4] + dz * f[5];
        const float z_l = dx * f[6] + dy * f[7] + dz * f[8];
        const float r = sqrtf(x_l * x_l + y_l * y_l + z_l * z_l);
        // torch.clamp keeps NaN: comparisons, not fminf / fmaxf
        const float rc = r < 1e-30f ? 1e-30f : r;
        // the minimum radius gate (a NaN r fails it, as in the twin)
        const bool use = !(min_r > 0.f) || r >= min_r;
        float c = z_l / rc;
        c = c < -1.0f ? -1.0f : (c > 1.0f ? 1.0f : c);
        const float theta = acosf(c) * RAD2DEG;
        const float phi = atan2f(y_l, x_l) * RAD2DEG;
        const float raw_r =
            log_r ? ((float)(r_bins - 1) * (logf(rc) - ln_rmin)) / ln_span +
                        1.0f
                  : (r_r * r) / rad;
        const float raw_t = (r_e * theta) / 180.0f;
        const float raw_p = (r_a * (phi + 180.0f)) / 360.0f;
        const int bin_r = clamp_bin((int)raw_r, r_bins);
        const int bin_t = min((int)raw_t, e_bins - 1);
        const int bin_p = min((int)raw_p, a_bins - 1);
        int off_r, off_t, off_p;
        const float w_r = interp(raw_r, off_r);
        const float w_t = interp(raw_t, off_t);
        const float w_p = interp(raw_p, off_p);
        const int bin_r2 = clamp_bin(bin_r + off_r, r_bins);
        const int bin_t2 = clamp_bin(bin_t + off_t, e_bins);
        int bin_p2 = bin_p + off_p;
        bin_p2 = bin_p2 < 0 ? a_bins - 1 : (bin_p2 >= a_bins ? 0 : bin_p2);
        const int re = r_bins * e_bins;
        const int lin = bin_r + bin_t * r_bins + bin_p * re;
        w[0] = use ? w_r + w_t + w_p : 0.f;
        bin[0] = lin;
        if (use && bin_p2 != bin_p && a_bins > 1) {
          w[1] = w_r + w_t + (1.0f - w_p);
          bin[1] = bin_r + bin_t * r_bins + bin_p2 * re;
        }
        if (use && bin_t2 != bin_t && e_bins > 1) {
          w[2] = w_r + (1.0f - w_t) + w_p;
          bin[2] = bin_r + bin_t2 * r_bins + bin_p * re;
        }
        if (use && bin_r2 != bin_r && r_bins > 1) {
          w[3] = (1.0f - w_r) + w_t + w_p;
          bin[3] = bin_r2 + bin_t * r_bins + bin_p * re;
        }
        // the twin's rule: a weight that is not > 0 moves its slot to bin
        // 0, a zero weight (or a bin outside [0, D)) adds nothing
#pragma unroll
        for (int s = 0; s < 4; ++s) {
          const int bs = w[s] > 0.f ? bin[s] : 0;
          bin[s] = (w[s] != 0.f && bs >= 0 && bs < D) ? bs : -1;
        }
      }
      const int n_act = __popc(__ballot_sync(FULL, act));   // lanes 0..n-1
      for (int p = 0; p < n_act; ++p) {
#pragma unroll
        for (int s = 0; s < 4; ++s) {
          const int bs = __shfl_sync(FULL, bin[s], p);
          const float ws = __shfl_sync(FULL, w[s], p);
          if (bs >= 0 && (bs & 31) == lane) {
#pragma unroll
            for (int q = 0; q < NQ; ++q)
              if ((bs >> 5) == q) acc[q] += ws;
          }
        }
      }
    };
    pairs::sweep<CH, 3, false>(st, src, mask + (size_t)b * N, N, on, f[9],
                               f[10], f[11], rad * rad, bin_batch);
  }
  if (row_ok) {
#pragma unroll
    for (int q = 0; q < NQ; ++q)
      if (q * 32 + lane < D) out[q * 32 + lane] = acc[q];
  }
}

template <int NQ>
int launch(const void* kp, const void* frames, const void* live,
           const void* points, const void* mask, void* hist, int B, int K,
           int N, int tiles, float r, int r_bins, int e_bins, int a_bins,
           float min_r, int log_r, float ln_rmin, float ln_span,
           void* stream) {
  short_shot_hist_kernel<NQ><<<B * tiles, THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)kp, (const float*)frames, (const unsigned char*)live,
      (const float*)points, (const unsigned char*)mask, (float*)hist, K, N,
      tiles, r, r_bins, e_bins, a_bins, min_r, log_r, ln_rmin, ln_span);
  return pcd_last_error();
}

}  // namespace

// kp [B*K, 3], frames [B*K, 9] (rows x, y, z axes), live [B*K] u8 (rows to
// describe), points [B, N, 3] f32, mask [B, N] u8; 1 <= r_bins * e_bins *
// a_bins = D <= 256; min_r (0: none), log_r (0 / 1) with ln_rmin and
// ln_span -> hist [B*K, D] f32 (raw; bin_r + bin_theta * r_bins + bin_phi *
// r_bins * e_bins); every element is written.  Returns
// cudaErrorInvalidValue for D outside [1, 256].
PCD_EXPORT int pcd_short_shot_hist(const void* kp, const void* frames,
                                   const void* live, const void* points,
                                   const void* mask, void* hist, int B, int K,
                                   int N, float r, int r_bins, int e_bins,
                                   int a_bins, float min_r, int log_r,
                                   float ln_rmin, float ln_span,
                                   void* stream) {
  const int D = r_bins * e_bins * a_bins;
  if (r_bins < 1 || e_bins < 1 || a_bins < 1 || D > 32 * MAX_NQ)
    return (int)cudaErrorInvalidValue;
  const int tiles = (K + TK - 1) / TK;
  if (B == 0 || tiles == 0) return pcd_last_error();
  switch ((D + 31) / 32) {
    case 1: return launch<1>(kp, frames, live, points, mask, hist, B, K, N,
                             tiles, r, r_bins, e_bins, a_bins, min_r, log_r,
                             ln_rmin, ln_span, stream);
    case 2: return launch<2>(kp, frames, live, points, mask, hist, B, K, N,
                             tiles, r, r_bins, e_bins, a_bins, min_r, log_r,
                             ln_rmin, ln_span, stream);
    case 3: return launch<3>(kp, frames, live, points, mask, hist, B, K, N,
                             tiles, r, r_bins, e_bins, a_bins, min_r, log_r,
                             ln_rmin, ln_span, stream);
    case 4: return launch<4>(kp, frames, live, points, mask, hist, B, K, N,
                             tiles, r, r_bins, e_bins, a_bins, min_r, log_r,
                             ln_rmin, ln_span, stream);
    case 5: return launch<5>(kp, frames, live, points, mask, hist, B, K, N,
                             tiles, r, r_bins, e_bins, a_bins, min_r, log_r,
                             ln_rmin, ln_span, stream);
    case 6: return launch<6>(kp, frames, live, points, mask, hist, B, K, N,
                             tiles, r, r_bins, e_bins, a_bins, min_r, log_r,
                             ln_rmin, ln_span, stream);
    case 7: return launch<7>(kp, frames, live, points, mask, hist, B, K, N,
                             tiles, r, r_bins, e_bins, a_bins, min_r, log_r,
                             ln_rmin, ln_span, stream);
    default: return launch<8>(kp, frames, live, points, mask, hist, B, K, N,
                              tiles, r, r_bins, e_bins, a_bins, min_r, log_r,
                             ln_rmin, ln_span, stream);
  }
}
