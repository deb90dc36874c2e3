// K10 radius moments on the tensor cores and K11 sign votes with the
// matmul-identity radius gate: the v2 forms of K1 and K2.
//
// Replaces point_cloud_donkey_tpu/ops/pallas/lrf_moments.py
// `_moments_call_v2` (K10) and `_sign_votes_call_v2` (K11), which
// `_moments_dispatch` / `_sign_votes_dispatch` select for `shot_lrf_pallas`
// under PCD_PALLAS_LRF_V=2 (K11 only without z_only).
//
// What they compute, for every query q and every point p of its cloud:
//   d2   = (|q|^2 + |p|^2) - 2 q.p in fp32, q.p as three fp32 products;
//   gate = d2 <= r^2 and p unmasked;
//   K10: w = r - sqrt(max(d2, 0)) ("shot") or 1 ("uniform") on the gate,
//        0 off it; the ten moments sum_p w F(p) with F = (1, x, y, z, xx,
//        yy, zz, xy, xz, yz) as the product W [queries x points] .
//        F [points x 16] on the tensor cores, split bf16x3 as the TPU
//        kernel splits it: W_hi F_hi + W_hi F_lo + W_lo F_hi, where
//        x_hi = bf16(x) and x_lo = bf16(x - x_hi) (the TPU's DEFAULT
//        precision passes round the lo parts to bf16 too), fp32
//        accumulation; the in-radius count as an integer sum;
//   K11: on the gate, #(a.p - a.q >= 0) for the x and z axis candidates a,
//        with a.q computed once per query.
// The TPU kernel computes the same sums as K1/K2 (`_moments_call`,
// `_sign_votes_call`) with the matrix unit carrying the per-pair products.
//
// What bounds them on the H100: fp32 work on the CUDA cores.  Every pair
// costs K10 ~14 fp32 operations (the gate, the select, the bf16 split of
// its weight) and a pair inside the radius 4 more (the weight and the
// count); every pair costs 96 bf16 tensor-core flops (3 products x 2 x 16
// columns), which at 989 TFLOP/s take half the time of the fp32 work at 67
// TFLOP/s.  Bytes are a few MB per call.  K11's three dots are k = 3
// products: on a tensor core a k = 3 product would fill one sixteenth of an
// mma's depth and still need the gate and the compares on the CUDA cores,
// so K11 runs them as fp32 multiplies and adds there, like K2 -- what the
// TPU kernel computes, not its matrix-unit blocks.
//
// K10 design: one CTA per (cloud, 64 queries), four warps of 16 queries.
// Point chunks of 512 are staged in shared memory as (x, y, z, |p|^2), with
// |p|^2 = NaN for masked points and for the slots past the cloud's end, so
// their gates fail.  The CTA then lays the chunk's bf16 hi / lo features
// out in the per-lane register order of the B operand of
// mma.m16n8k16.row.col (two 16-byte loads per lane and step).  Each lane
// computes its 8 entries of the warp's 16 x 16 weight tile directly in the
// A-operand layout (rows g and g + 8, columns 2t, 2t + 1, 2t + 8, 2t + 9
// of lane 4g + t), splits them, and issues 2 n-tiles x 3 products per
// 16-point step into two fp32 accumulators in registers.  The counts are
// summed across the four lanes of a row with two shuffles.  No atomics:
// the sums have a fixed order on every run.
// K11 design: K2's -- one thread per query, 128 queries a CTA, 1024-point
// chunks of (x, y, z, |p|^2) in shared memory; the dots run only on the
// pairs inside the gate.
#include <cuda_bf16.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int WARPS = 4;
constexpr int THREADS10 = WARPS * 32;  // K10 threads per CTA
constexpr int TQ10 = WARPS * 16;   // queries per K10 CTA (16 per warp)
constexpr int TN10 = 512;          // points per staged K10 chunk
constexpr int STEPS = TN10 / 16;   // 16-point mma steps per chunk
constexpr int TQ11 = 128;          // queries per K11 CTA (one per thread)
constexpr int TN11 = 1024;         // points per staged K11 chunk

__device__ __forceinline__ float nan_f() { return __int_as_float(0x7fffffff); }

// (x, y, z, |p|^2) of points [base, base + n) of one cloud into slots
// [0, slots); masked points and slots past n get |p|^2 = NaN
__device__ __forceinline__ void stage_points(float4* sp, const float* pb,
                                             const unsigned char* mb,
                                             int base, int n, int slots) {
  for (int j = threadIdx.x; j < slots; j += blockDim.x) {
    float4 v = make_float4(0.f, 0.f, 0.f, nan_f());
    if (j < n && mb[base + j]) {
      const float* pp = pb + (size_t)(base + j) * 3;
      const float x = pp[0], y = pp[1], z = pp[2];
      v = make_float4(x, y, z, x * x + y * y + z * z);
    }
    sp[j] = v;
  }
}

__device__ __forceinline__ uint32_t pack(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) |
         ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

// bf16 hi / lo parts of a and b, packed as one mma register each (a in the
// low half, the lower k index)
__device__ __forceinline__ void split2(float a, float b, uint32_t& hi,
                                       uint32_t& lo) {
  const __nv_bfloat16 ah = __float2bfloat16_rn(a);
  const __nv_bfloat16 bh = __float2bfloat16_rn(b);
  hi = pack(ah, bh);
  lo = pack(__float2bfloat16_rn(a - __bfloat162float(ah)),
            __float2bfloat16_rn(b - __bfloat162float(bh)));
}

// feature column c of a staged point: 1, x, y, z, xx, yy, zz, xy, xz, yz,
// then zeros; 0 for a masked point (its weight is 0 in every row)
__device__ __forceinline__ float feature(const float4& p, int c) {
  if (isnan(p.w)) return 0.f;
  switch (c) {
    case 0: return 1.f;
    case 1: return p.x;
    case 2: return p.y;
    case 3: return p.z;
    case 4: return p.x * p.x;
    case 5: return p.y * p.y;
    case 6: return p.z * p.z;
    case 7: return p.x * p.y;
    case 8: return p.x * p.z;
    case 9: return p.y * p.z;
    default: return 0.f;
  }
}

// the B fragments of every 16-point step of a staged chunk: entry
// s * 32 + lane holds lane's registers {n-tile 0: k 2t..2t+1, k 2t+8..2t+9;
// n-tile 1: the same} for column g (n-tile 0) and 8 + g (n-tile 1)
__device__ __forceinline__ void stage_features(uint4* sf_hi, uint4* sf_lo,
                                               const float4* sp, int steps) {
  for (int i = threadIdx.x; i < steps * 32; i += blockDim.x) {
    const int lane = i & 31, g = lane >> 2, t = lane & 3;
    const float4* p = sp + (i >> 5) * 16 + 2 * t;
    uint32_t h[4], l[4];
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      const int c = nt * 8 + g;
      split2(feature(p[0], c), feature(p[1], c), h[2 * nt], l[2 * nt]);
      split2(feature(p[8], c), feature(p[9], c), h[2 * nt + 1],
             l[2 * nt + 1]);
    }
    sf_hi[i] = make_uint4(h[0], h[1], h[2], h[3]);
    sf_lo[i] = make_uint4(l[0], l[1], l[2], l[3]);
  }
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// (x, y, z, |q|^2) of query qi of cloud b (zeros past Q: such rows are
// computed and never written)
__device__ __forceinline__ float4 load_query(const float* q, int b, int qi,
                                             int Q) {
  if (qi >= Q) return make_float4(0.f, 0.f, 0.f, 0.f);
  const float* qq = q + ((size_t)b * Q + qi) * 3;
  const float x = qq[0], y = qq[1], z = qq[2];
  return make_float4(x, y, z, x * x + y * y + z * z);
}

// the identity gate of one pair and its weight; returns the gate
template <bool SHOT>
__device__ __forceinline__ int weight(const float4& q, const float4& p,
                                      float r, float r2, float& w) {
  const float qp = q.x * p.x + q.y * p.y + q.z * p.z;
  const float d2 = (q.w + p.w) - 2.f * qp;
  const bool in = d2 <= r2;
  w = in ? (SHOT ? r - sqrtf(fmaxf(d2, 0.f)) : 1.f) : 0.f;
  return in;
}

template <bool SHOT>
__global__ void __launch_bounds__(THREADS10)
lrf_moments_v2_kernel(const float* __restrict__ q, const float* __restrict__ p,
                      const unsigned char* __restrict__ mask,
                      float* __restrict__ mom, int* __restrict__ count, int Q,
                      int N, float r) {
  __shared__ float4 sp[TN10];
  __shared__ uint4 sf_hi[STEPS * 32];
  __shared__ uint4 sf_lo[STEPS * 32];
  const int b = blockIdx.y;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int qa = blockIdx.x * TQ10 + (threadIdx.x >> 5) * 16 + g;
  const int qb = qa + 8;
  const float r2 = r * r;
  const float4 A = load_query(q, b, qa, Q);
  const float4 Bq = load_query(q, b, qb, Q);
  float acc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
  int cnt_a = 0, cnt_b = 0;
  const float* pb = p + (size_t)b * N * 3;
  const unsigned char* mb = mask + (size_t)b * N;
  for (int base = 0; base < N; base += TN10) {
    const int n = min(TN10, N - base);
    const int steps = (n + 15) / 16;
    __syncthreads();
    stage_points(sp, pb, mb, base, n, steps * 16);
    __syncthreads();
    stage_features(sf_hi, sf_lo, sp, steps);
    __syncthreads();
    for (int s = 0; s < steps; ++s) {
      const float4* ps = sp + s * 16 + 2 * t;
      const float4 p0 = ps[0], p1 = ps[1], p8 = ps[8], p9 = ps[9];
      float wa0, wa1, wa8, wa9, wb0, wb1, wb8, wb9;
      cnt_a += weight<SHOT>(A, p0, r, r2, wa0) + weight<SHOT>(A, p1, r, r2, wa1)
             + weight<SHOT>(A, p8, r, r2, wa8) + weight<SHOT>(A, p9, r, r2, wa9);
      cnt_b += weight<SHOT>(Bq, p0, r, r2, wb0)
             + weight<SHOT>(Bq, p1, r, r2, wb1)
             + weight<SHOT>(Bq, p8, r, r2, wb8)
             + weight<SHOT>(Bq, p9, r, r2, wb9);
      uint32_t ah[4], al[4];
      split2(wa0, wa1, ah[0], al[0]);   // row g,     k 2t, 2t + 1
      split2(wb0, wb1, ah[1], al[1]);   // row g + 8, k 2t, 2t + 1
      split2(wa8, wa9, ah[2], al[2]);   // row g,     k 2t + 8, 2t + 9
      split2(wb8, wb9, ah[3], al[3]);   // row g + 8, k 2t + 8, 2t + 9
      const uint4 fh = sf_hi[s * 32 + lane];
      const uint4 fl = sf_lo[s * 32 + lane];
      mma_bf16(acc[0], ah, fh.x, fh.y);
      mma_bf16(acc[0], ah, fl.x, fl.y);
      mma_bf16(acc[0], al, fh.x, fh.y);
      mma_bf16(acc[1], ah, fh.z, fh.w);
      mma_bf16(acc[1], ah, fl.z, fl.w);
      mma_bf16(acc[1], al, fh.z, fh.w);
    }
  }
  cnt_a += __shfl_xor_sync(0xffffffffu, cnt_a, 1);
  cnt_a += __shfl_xor_sync(0xffffffffu, cnt_a, 2);
  cnt_b += __shfl_xor_sync(0xffffffffu, cnt_b, 1);
  cnt_b += __shfl_xor_sync(0xffffffffu, cnt_b, 2);
  // accumulator i of lane 4g + t: row g (i < 2) or g + 8, column 2t + i % 2
  // of its n-tile; columns 10-15 are the zero features
  if (qa < Q) {
    float* o = mom + ((size_t)b * Q + qa) * 10;
    o[2 * t] = acc[0][0];
    o[2 * t + 1] = acc[0][1];
    if (t == 0) {
      o[8] = acc[1][0];
      o[9] = acc[1][1];
      count[(size_t)b * Q + qa] = cnt_a;
    }
  }
  if (qb < Q) {
    float* o = mom + ((size_t)b * Q + qb) * 10;
    o[2 * t] = acc[0][2];
    o[2 * t + 1] = acc[0][3];
    if (t == 0) {
      o[8] = acc[1][2];
      o[9] = acc[1][3];
      count[(size_t)b * Q + qb] = cnt_b;
    }
  }
}

__global__ void __launch_bounds__(TQ11)
sign_votes_v2_kernel(const float* __restrict__ q, const float* __restrict__ p,
                     const unsigned char* __restrict__ mask,
                     const float* __restrict__ axes, int* __restrict__ votes,
                     int Q, int N, float r) {
  __shared__ float4 sp[TN11];
  const int b = blockIdx.y;
  const int qi = blockIdx.x * TQ11 + threadIdx.x;
  const bool active = qi < Q;
  const float r2 = r * r;
  const float4 qv4 = load_query(q, b, qi, Q);
  float vx = 0.f, vy = 0.f, vz = 0.f, ux = 0.f, uy = 0.f, uz = 0.f;
  if (active) {
    const float* a = axes + ((size_t)b * Q + qi) * 6;
    vx = a[0]; vy = a[1]; vz = a[2];
    ux = a[3]; uy = a[4]; uz = a[5];
  }
  const float qv = qv4.x * vx + qv4.y * vy + qv4.z * vz;   // x candidate . q
  const float qu = qv4.x * ux + qv4.y * uy + qv4.z * uz;   // z candidate . q
  int plus_x = 0, plus_z = 0;
  const float* pb = p + (size_t)b * N * 3;
  const unsigned char* mb = mask + (size_t)b * N;
  for (int base = 0; base < N; base += TN11) {
    const int n = min(TN11, N - base);
    __syncthreads();
    stage_points(sp, pb, mb, base, n, n);
    __syncthreads();
    if (!active) continue;
    for (int j = 0; j < n; ++j) {
      const float4 pt = sp[j];
      const float qp = qv4.x * pt.x + qv4.y * pt.y + qv4.z * pt.z;
      const float d2 = (qv4.w + pt.w) - 2.f * qp;
      if (d2 <= r2) {
        plus_x += (pt.x * vx + pt.y * vy + pt.z * vz) - qv >= 0.f;
        plus_z += (pt.x * ux + pt.y * uy + pt.z * uz) - qu >= 0.f;
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
// -> mom [B, Q, 10] f32 (s0, s1 xyz, s2 xx yy zz xy xz yz), count [B, Q]
// i32; shot = 1 for the (r - d) weights, 0 for uniform ones
PCD_EXPORT int pcd_lrf_moments_v2(const void* q, const void* p,
                                  const void* mask, void* mom, void* count,
                                  int B, int Q, int N, float r, int shot,
                                  void* stream) {
  dim3 grid((Q + TQ10 - 1) / TQ10, B);
  if (shot) {
    lrf_moments_v2_kernel<true><<<grid, THREADS10, 0,
                                   (cudaStream_t)stream>>>(
        (const float*)q, (const float*)p, (const unsigned char*)mask,
        (float*)mom, (int*)count, Q, N, r);
  } else {
    lrf_moments_v2_kernel<false><<<grid, THREADS10, 0,
                                    (cudaStream_t)stream>>>(
        (const float*)q, (const float*)p, (const unsigned char*)mask,
        (float*)mom, (int*)count, Q, N, r);
  }
  return pcd_last_error();
}

// axes [B, Q, 6] f32 (x candidate, z candidate) -> votes [B, Q, 2] i32
// (in-radius counts with a.p - a.q >= 0 for x, z)
PCD_EXPORT int pcd_sign_votes_v2(const void* q, const void* p,
                                 const void* mask, const void* axes,
                                 void* votes, int B, int Q, int N, float r,
                                 void* stream) {
  dim3 grid((Q + TQ11 - 1) / TQ11, B);
  sign_votes_v2_kernel<<<grid, TQ11, 0, (cudaStream_t)stream>>>(
      (const float*)q, (const float*)p, (const unsigned char*)mask,
      (const float*)axes, (int*)votes, Q, N, r);
  return pcd_last_error();
}
