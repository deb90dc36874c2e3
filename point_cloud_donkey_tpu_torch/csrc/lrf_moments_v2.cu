// K11 sign votes with the matmul-identity radius gate: the v2 form of K2.
// (K10, the v2 moments, is a body of the cell-binned sweep in
// lrf_moments.cu.)
//
// Replaces point_cloud_donkey_tpu/ops/pallas/lrf_moments.py
// `_sign_votes_call_v2` (K11), which `_sign_votes_dispatch` selects for
// `shot_lrf_pallas` under PCD_PALLAS_LRF_V=2 (without z_only).
//
// What it computes, for every query q and every point p of its cloud:
//   d2   = (|q|^2 + |p|^2) - 2 q.p in fp32, q.p as three fp32 products;
//   gate = d2 <= r^2 and p unmasked;
//   on the gate, #(a.p - a.q >= 0) for the x and z axis candidates a,
//   with a.q computed once per query.
// The TPU kernel computes the same sums as K2 (`_sign_votes_call`) with
// the matrix unit carrying the per-pair products.
//
// What bounds it on the H100: fp32 work on the CUDA cores.  Its three dots
// are k = 3 products: on a tensor core a k = 3 product would fill one
// sixteenth of an mma's depth and still need the gate and the compares on
// the CUDA cores, so K11 runs them as fp32 multiplies and adds there, like
// K2 -- what the TPU kernel computes, not its matrix-unit blocks.
//
// Design: K2's first one -- one thread per query, 128 queries a CTA,
// 1024-point chunks of (x, y, z, |p|^2) in shared memory, |p|^2 = NaN for
// masked points so their gates fail; the dots run only on the pairs inside
// the gate.
#include "common.cuh"

namespace {

constexpr int TQ11 = 128;          // K11 queries per CTA (one per thread)
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

// (x, y, z, |q|^2) of query qi of cloud b (zeros past Q: such rows are
// computed and never written)
__device__ __forceinline__ float4 load_query(const float* q, int b, int qi,
                                             int Q) {
  if (qi >= Q) return make_float4(0.f, 0.f, 0.f, 0.f);
  const float* qq = q + ((size_t)b * Q + qi) * 3;
  const float x = qq[0], y = qq[1], z = qq[2];
  return make_float4(x, y, z, x * x + y * y + z * z);
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
