// K1 radius moments and K2 sign votes of the SHOT local reference frame,
// and their windowed forms K5 and K6.
//
// Replaces point_cloud_donkey_tpu/ops/pallas/lrf_moments.py `_moments_call`
// (K1) and `_sign_votes_call` (K2), reached through `shot_lrf_pallas`, and
// `_moments_call_gathered` (K5) and `_sign_votes_call_gathered` (K6),
// reached through `shot_lrf_pallas_windowed`.
//
// K1: for every query q and every point p of its cloud with |p - q|^2 <= r^2
// (exact coordinate differences), accumulate w = r - |p - q| into
//   s0 = sum w, s1 = sum w p (3), s2 = sum w p p^T (6 unique entries)
// and the in-radius count.  Coordinates arrive centroid-shifted (the
// wrapper subtracts the cloud's masked mean), which keeps the moment
// identity cov = s2 - c s1^T - s1 c^T + s0 c c^T well conditioned.
// K2: for every query, count the in-radius points with (p - q) . axis >= 0
// for the x and z axis candidates of its frame (z only when z_only).
// K5 / K6: the same sums, but the points of each cloud are sorted along its
// principal axis and every tile of TQW = 256 consecutive queries sweeps
// only its own window [start, start + W) of them (ops/binned.py plans the
// starts; exactness is the caller's contract).
//
// What bounds it on the H100: arithmetic.  Each (query, point) pair costs
// ~30 fp32 operations and one sqrt (K1) or ~20 operations (K2); a 128-cloud
// batch at N = 2048 has 5.4e8 pairs per pass and reads only ~3 MB.  The
// window cuts the pairs of the normals pass to W / N (1280 / 2048 = 62.5%
// at the bench calibration); the bytes stay a few MB.
// Design: one CTA per (cloud, tile of 128 queries), batched over clouds in
// one launch (grid.y = cloud); one thread per query keeps its 11 sums (or 2
// counts) in registers; the swept points stream through shared memory in
// 1024-point chunks as float4 (x, y, z, mask), so every point is read from
// device memory once per CTA and broadcast to all threads from shared
// memory.  No atomics and no cross-CTA reduction: each thread owns its
// query's sums.  The windowed kernels are the same code with the sweep
// range read from the plan: both 128-query CTAs of a 256-query plan tile
// read the same start, so no window is ever pre-gathered (the TPU's
// [8, T * W] slab was a lane-layout workaround).  The 3x3 EVD between the
// two passes stays in PyTorch.
#include "common.cuh"

namespace {

constexpr int TQ = 128;   // queries per CTA (one thread each)
constexpr int TN = 1024;  // points staged in shared memory per chunk
constexpr int TQW = 256;  // queries per window-plan tile (2 CTAs)
static_assert(TQW % TQ == 0, "a CTA must lie inside one plan tile");

// Sweep range [lo, hi) of this CTA's queries: the whole cloud, or the
// window its plan tile was given (starts [B, T], clamped to N).
template <bool WIN>
__device__ __forceinline__ void sweep_range(const int* __restrict__ starts,
                                            int T, int W, int N, int& lo,
                                            int& hi) {
  if (WIN) {
    lo = starts[(size_t)blockIdx.y * T + (blockIdx.x * TQ) / TQW];
    lo = max(0, min(lo, N));
    hi = min(lo + W, N);
  } else {
    lo = 0;
    hi = N;
  }
}

__device__ __forceinline__ void stage_points(float4* sp, const float* pb,
                                             const unsigned char* mb,
                                             int base, int n) {
  for (int j = threadIdx.x; j < n; j += blockDim.x) {
    const float* pp = pb + (size_t)(base + j) * 3;
    sp[j] = make_float4(pp[0], pp[1], pp[2], mb[base + j] ? 1.f : 0.f);
  }
}

template <bool WIN>
__global__ void __launch_bounds__(TQ)
lrf_moments_kernel(const float* __restrict__ q, const float* __restrict__ p,
                   const unsigned char* __restrict__ mask,
                   const int* __restrict__ starts,
                   float* __restrict__ mom, int* __restrict__ count,
                   int Q, int N, int T, int W, float r) {
  __shared__ float4 sp[TN];
  const int b = blockIdx.y;
  const int qi = blockIdx.x * TQ + threadIdx.x;
  const bool active = qi < Q;
  const float r2 = r * r;
  float qx = 0.f, qy = 0.f, qz = 0.f;
  if (active) {
    const float* qq = q + ((size_t)b * Q + qi) * 3;
    qx = qq[0]; qy = qq[1]; qz = qq[2];
  }
  float s0 = 0.f, sx = 0.f, sy = 0.f, sz = 0.f;
  float xx = 0.f, yy = 0.f, zz = 0.f, xy = 0.f, xz = 0.f, yz = 0.f;
  int cnt = 0;
  const float* pb = p + (size_t)b * N * 3;
  const unsigned char* mb = mask + (size_t)b * N;
  int lo, hi;
  sweep_range<WIN>(starts, T, W, N, lo, hi);
  for (int base = lo; base < hi; base += TN) {
    const int n = min(TN, hi - base);
    __syncthreads();
    stage_points(sp, pb, mb, base, n);
    __syncthreads();
    if (!active) continue;
    for (int j = 0; j < n; ++j) {
      const float4 pt = sp[j];
      const float dx = qx - pt.x, dy = qy - pt.y, dz = qz - pt.z;
      const float d2 = dx * dx + dy * dy + dz * dz;
      if (d2 <= r2 && pt.w != 0.f) {
        const float w = r - sqrtf(d2);
        const float wx = w * pt.x, wy = w * pt.y, wz = w * pt.z;
        s0 += w; sx += wx; sy += wy; sz += wz;
        xx += wx * pt.x; yy += wy * pt.y; zz += wz * pt.z;
        xy += wx * pt.y; xz += wx * pt.z; yz += wy * pt.z;
        ++cnt;
      }
    }
  }
  if (active) {
    float* o = mom + ((size_t)b * Q + qi) * 10;
    o[0] = s0; o[1] = sx; o[2] = sy; o[3] = sz;
    o[4] = xx; o[5] = yy; o[6] = zz; o[7] = xy; o[8] = xz; o[9] = yz;
    count[(size_t)b * Q + qi] = cnt;
  }
}

template <bool WIN>
__global__ void __launch_bounds__(TQ)
sign_votes_kernel(const float* __restrict__ q, const float* __restrict__ p,
                  const unsigned char* __restrict__ mask,
                  const int* __restrict__ starts,
                  const float* __restrict__ axes, int* __restrict__ votes,
                  int Q, int N, int T, int W, float r, int z_only) {
  __shared__ float4 sp[TN];
  const int b = blockIdx.y;
  const int qi = blockIdx.x * TQ + threadIdx.x;
  const bool active = qi < Q;
  const float r2 = r * r;
  float qx = 0.f, qy = 0.f, qz = 0.f;
  float vx = 0.f, vy = 0.f, vz = 0.f, ux = 0.f, uy = 0.f, uz = 0.f;
  if (active) {
    const size_t row = (size_t)b * Q + qi;
    const float* qq = q + row * 3;
    qx = qq[0]; qy = qq[1]; qz = qq[2];
    const float* a = axes + row * 6;
    vx = a[0]; vy = a[1]; vz = a[2];
    ux = a[3]; uy = a[4]; uz = a[5];
  }
  int plus_x = 0, plus_z = 0;
  const float* pb = p + (size_t)b * N * 3;
  const unsigned char* mb = mask + (size_t)b * N;
  int lo, hi;
  sweep_range<WIN>(starts, T, W, N, lo, hi);
  for (int base = lo; base < hi; base += TN) {
    const int n = min(TN, hi - base);
    __syncthreads();
    stage_points(sp, pb, mb, base, n);
    __syncthreads();
    if (!active) continue;
    for (int j = 0; j < n; ++j) {
      const float4 pt = sp[j];
      const float dx = pt.x - qx, dy = pt.y - qy, dz = pt.z - qz;
      const float d2 = dx * dx + dy * dy + dz * dz;
      if (d2 <= r2 && pt.w != 0.f) {
        plus_z += (dx * ux + dy * uy + dz * uz) >= 0.f;
        if (!z_only) plus_x += (dx * vx + dy * vy + dz * vz) >= 0.f;
      }
    }
  }
  if (active) {
    int* o = votes + ((size_t)b * Q + qi) * 2;
    o[0] = plus_x;
    o[1] = plus_z;
  }
}

}  // namespace

// q [B, Q, 3], p [B, N, 3] f32 (centroid-shifted), mask [B, N] u8
// -> mom [B, Q, 10] f32 (s0, s1 xyz, s2 xx yy zz xy xz yz), count [B, Q] i32
PCD_EXPORT int pcd_lrf_moments(const void* q, const void* p, const void* mask,
                               void* mom, void* count, int B, int Q, int N,
                               float r, void* stream) {
  dim3 grid((Q + TQ - 1) / TQ, B);
  lrf_moments_kernel<false><<<grid, TQ, 0, (cudaStream_t)stream>>>(
      (const float*)q, (const float*)p, (const unsigned char*)mask, nullptr,
      (float*)mom, (int*)count, Q, N, 0, N, r);
  return pcd_last_error();
}

// as pcd_lrf_moments over sorted points, each 256-query tile t of cloud b
// sweeping points [starts[b, t], starts[b, t] + W); starts [B, T] i32 with
// T = ceil(Q / 256)
PCD_EXPORT int pcd_lrf_moments_windowed(const void* q, const void* p,
                                        const void* mask, const void* starts,
                                        void* mom, void* count, int B, int Q,
                                        int N, int T, int W, float r,
                                        void* stream) {
  dim3 grid((Q + TQ - 1) / TQ, B);
  lrf_moments_kernel<true><<<grid, TQ, 0, (cudaStream_t)stream>>>(
      (const float*)q, (const float*)p, (const unsigned char*)mask,
      (const int*)starts, (float*)mom, (int*)count, Q, N, T, W, r);
  return pcd_last_error();
}

// axes [B, Q, 6] f32 (x candidate, z candidate) -> votes [B, Q, 2] i32
// (in-radius counts with (p - q) . axis >= 0 for x, z; x is 0 when z_only)
PCD_EXPORT int pcd_sign_votes(const void* q, const void* p, const void* mask,
                              const void* axes, void* votes, int B, int Q,
                              int N, float r, int z_only, void* stream) {
  dim3 grid((Q + TQ - 1) / TQ, B);
  sign_votes_kernel<false><<<grid, TQ, 0, (cudaStream_t)stream>>>(
      (const float*)q, (const float*)p, (const unsigned char*)mask, nullptr,
      (const float*)axes, (int*)votes, Q, N, 0, N, r, z_only);
  return pcd_last_error();
}

// as pcd_sign_votes over the windows of pcd_lrf_moments_windowed
PCD_EXPORT int pcd_sign_votes_windowed(const void* q, const void* p,
                                       const void* mask, const void* starts,
                                       const void* axes, void* votes, int B,
                                       int Q, int N, int T, int W, float r,
                                       int z_only, void* stream) {
  dim3 grid((Q + TQ - 1) / TQ, B);
  sign_votes_kernel<true><<<grid, TQ, 0, (cudaStream_t)stream>>>(
      (const float*)q, (const float*)p, (const unsigned char*)mask,
      (const int*)starts, (const float*)axes, (int*)votes, Q, N, T, W, r,
      z_only);
  return pcd_last_error();
}

PCD_EXPORT const char* pcd_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
