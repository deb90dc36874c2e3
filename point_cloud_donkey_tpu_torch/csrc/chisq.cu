// K4: exact chi-square distances with a fused running top-k (k <= 3).
//
// Replaces point_cloud_donkey_tpu/ops/pallas/chisq.py `_chisq_call`
// (`chi_square_distance_matrix_pallas`), the flann::ChiSquareDistance
// matrix d(a, b) = sum_i (a_i - b_i)^2 / (a_i + b_i) over terms with
// a_i + b_i > 0, followed -- here in the same kernel -- by the k nearest
// codewords of `ops/neighbors.knn` (masked codewords at +inf, ties to the
// lower index as lax.top_k gives them).  The [Q, C] matrix never reaches
// device memory: only [Q, k] distances and indices are written.
//
// What bounds it on the H100: the reciprocal and the issue slots.  The
// serving batch has ~1.2e4 descriptors x 458 codewords x 352 dims ~ 1.9e9
// terms.  A term is one reciprocal on the special-function unit and six
// more instructions (a + b, a - b, the s >= FLT_MIN test, the zeroed
// destination of the predicated reciprocal, d * d, the fused multiply-add
// into the sum).  The unit issues 16 reciprocals a clock per SM, so one a
// term puts the floor at terms / (16 x 132 x clock), ~0.46 ms at the data
// sheet's 1.98 GHz; seven issue slots a term put another at ~0.40 ms; both
// lie above the fp32 bound (~0.17 ms).  Sharing one reciprocal between two
// terms (1 / s1 = s2 / (s1 s2), behind a per-chunk range check) halves the
// unit's work but keeps ~7 slots a term, and was slower on the card: not
// used.  Bytes are negligible (the codebook is 0.6 MB and stays in L2).
//
// Design:
// - Register tiles.  A CTA of 128 threads owns TQ descriptors; each thread
//   owns a 4 x 4 micro-tile (4 descriptors x 4 consecutive codewords) and
//   keeps its 16 sums in registers.  Descriptor and codeword chunks of DK
//   dims sit d-major in shared memory, so one 16-byte load feeds four
//   pairs: two loads per 16 terms.
// - The term.  r = rcp.approx.ftz(s), selected to 0 unless s >= FLT_MIN,
//   then sum = fma(d * d, r, sum); no branch and no IEEE division.  The
//   reciprocal's error is at most 1 ulp, so each term is within ~2 ulp of
//   the correctly rounded d^2 / s, and a sum of positive terms within
//   ~2^-22 relative of the plain twin's (rtol 1e-5 is the contract).  A
//   subnormal s (0 < s < FLT_MIN) gives 0 as the division does: it needs
//   |a|, |b| < 2^-102, so d * d underflows to 0 and d^2 / s = 0.  Inputs
//   above 2^125 in magnitude are out of contract (ftz flushes 1 / s to 0
//   there); descriptors are normalised histograms in [0, 1].
// - Top-k.  Each thread keeps a running top-k of its own codewords for its
//   4 descriptors in registers (a branch-free insertion in (distance,
//   index) order).  At the end the 16 threads that share a descriptor merge
//   with warp shuffles, once; with G > 1 codeword groups (below) the group
//   results meet once in shared memory.  No per-tile barrier or serial
//   merge.
// - Memory.  Chunks stream through a two-stage cp.async ring (4-byte
//   copies, transposed to d-major, zero-filled past Q, C and D), so the
//   next chunk's loads overlap this chunk's math.
// - Grid.  TQ = 32 / G descriptors a CTA, with G codeword groups of
//   128 / G threads each taking every G-th 64-codeword tile: the host picks
//   the smallest G in {1, 2, 4} that gives >= 2 CTAs per SM, so the serving
//   batch (Q ~ 12k: 374 CTAs, G = 1) and the training self-kNN (Q ~ 2k:
//   G = 4) both fill the 132 SMs evenly.  Any D (a ragged tail is
//   zero-filled and contributes 0), any C, k in {1, 2, 3}.
#include <cfloat>
#include <climits>
#include <cmath>

#include "common.cuh"

namespace {

constexpr int THREADS = 128;
constexpr int TX = 16;          // threads along the codewords of a tile
constexpr int MQ = 4;           // descriptors per thread
constexpr int MC = 4;           // codewords per thread
constexpr int TC = TX * MC;     // codewords per tile
constexpr int PAD = 4;          // keeps float4 rows aligned, spreads banks

__device__ __forceinline__ bool before(float d, int i, float bd, int bi) {
  return d < bd || (d == bd && i < bi);
}

// Insert (d, i) into the ascending list (bd, bi) of length K, branch-free.
template <int K>
__device__ __forceinline__ void insert(float (&bd)[K], int (&bi)[K], float d,
                                       int i) {
#pragma unroll
  for (int s = 0; s < K; ++s) {
    const bool b = before(d, i, bd[s], bi[s]);
    const float td = b ? d : bd[s];
    const int ti = b ? i : bi[s];
    d = b ? bd[s] : d;
    i = b ? bi[s] : i;
    bd[s] = td;
    bi[s] = ti;
  }
}

__device__ __forceinline__ float rcp_approx(float x) {
  float y;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float chisq_term(float x, float y, float acc) {
  const float s = __fadd_rn(x, y);
  const float d = __fsub_rn(x, y);
  const float r = s >= FLT_MIN ? rcp_approx(s) : 0.f;
  return __fmaf_rn(__fmul_rn(d, d), r, acc);
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool in) {
  const unsigned saddr = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(saddr),
               "l"(src), "r"(in ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N));
}

template <int G>
struct Tile {
  static constexpr int TY = 8 / G;                 // thread rows per group
  static constexpr int TQ = TY * MQ;               // descriptors per CTA
  static constexpr int DK = G == 1 ? 32 : 16;      // dims per chunk
  float a[2][DK][TQ + PAD];
  float b[2][G][DK][TC + PAD];
};

// Stage chunk `step` (codeword tile ct = group tile, dims d0..) of every
// group into stage st: descriptors q0.. and each group's codeword tile.
template <int G>
__device__ __forceinline__ void stage(Tile<G>& sm, int st, const float* a,
                                      const float* b, int q0, int Q, int C,
                                      int D, int d0, int ct0) {
  constexpr int TQ = Tile<G>::TQ, DK = Tile<G>::DK;
  for (int e = threadIdx.x; e < TQ * DK; e += THREADS) {
    const int r = e / DK, dd = e % DK, d = d0 + dd, qi = q0 + r;
    const bool in = qi < Q && d < D;
    cp_async4(&sm.a[st][dd][r], in ? a + (size_t)qi * D + d : a, in);
  }
  for (int e = threadIdx.x; e < G * TC * DK; e += THREADS) {
    const int g = e / (TC * DK), rem = e % (TC * DK);
    const int r = rem / DK, dd = rem % DK, d = d0 + dd;
    const int ci = (ct0 + g) * TC + r;
    const bool in = ci < C && d < D;
    cp_async4(&sm.b[st][g][dd][r], in ? b + (size_t)ci * D + d : b, in);
  }
}

template <int G, int K>
__global__ void __launch_bounds__(THREADS)
chisq_topk_kernel(const float* __restrict__ a, const float* __restrict__ b,
                  const unsigned char* __restrict__ bmask,
                  float* __restrict__ out_d, int* __restrict__ out_i, int Q,
                  int C, int D) {
  using T = Tile<G>;
  constexpr int TQ = T::TQ, DK = T::DK;
  __shared__ __align__(16) T sm;
  __shared__ float res_d[G][TQ][K];
  __shared__ int res_i[G][TQ][K];

  const int g = threadIdx.x / (THREADS / G);
  const int t = threadIdx.x % (THREADS / G);
  const int tx = t % TX, ty = t / TX;
  const int q0 = blockIdx.x * TQ;

  float bd[MQ][K];
  int bi[MQ][K];
#pragma unroll
  for (int i = 0; i < MQ; ++i)
#pragma unroll
    for (int s = 0; s < K; ++s) {
      bd[i][s] = INFINITY;
      bi[i][s] = INT_MAX;
    }

  // steps walk (round of G codeword tiles, dim chunk); group g computes
  // codeword tile round * G + g
  const int n_tiles = (C + TC - 1) / TC;
  const int n_rounds = (n_tiles + G - 1) / G;
  const int n_chunks = (D + DK - 1) / DK;
  const int n_steps = n_rounds * n_chunks;

  float acc[MQ][MC];
#pragma unroll
  for (int i = 0; i < MQ; ++i)
#pragma unroll
    for (int j = 0; j < MC; ++j) acc[i][j] = 0.f;

  stage<G>(sm, 0, a, b, q0, Q, C, D, 0, 0);
  cp_async_commit();
  for (int step = 0; step < n_steps; ++step) {
    const int st = step & 1;
    const int round = step / n_chunks, chunk = step % n_chunks;
    if (step + 1 < n_steps) {
      const int nr = (step + 1) / n_chunks, nc = (step + 1) % n_chunks;
      stage<G>(sm, st ^ 1, a, b, q0, Q, C, D, nc * DK, nr * G);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
#pragma unroll 8
    for (int dd = 0; dd < DK; ++dd) {
      const float4 av =
          *reinterpret_cast<const float4*>(&sm.a[st][dd][ty * MQ]);
      const float4 bv =
          *reinterpret_cast<const float4*>(&sm.b[st][g][dd][tx * MC]);
      const float xa[MQ] = {av.x, av.y, av.z, av.w};
      const float yb[MC] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int i = 0; i < MQ; ++i)
#pragma unroll
        for (int j = 0; j < MC; ++j)
          acc[i][j] = chisq_term(xa[i], yb[j], acc[i][j]);
    }
    if (chunk == n_chunks - 1) {
      // this group's tile is complete: fold it into the running top-k
      const int c0 = (round * G + g) * TC + tx * MC;
#pragma unroll
      for (int j = 0; j < MC; ++j) {
        const int ci = c0 + j;
        if (ci < C) {
          const bool live = bmask[ci] != 0;
#pragma unroll
          for (int i = 0; i < MQ; ++i)
            insert<K>(bd[i], bi[i], live ? acc[i][j] : INFINITY, ci);
        }
      }
#pragma unroll
      for (int i = 0; i < MQ; ++i)
#pragma unroll
        for (int j = 0; j < MC; ++j) acc[i][j] = 0.f;
    }
    __syncthreads();   // stage st is refilled by the next step's prefetch
  }

  // merge the TX threads that share each descriptor: xor butterfly
#pragma unroll
  for (int off = TX / 2; off > 0; off >>= 1) {
#pragma unroll
    for (int i = 0; i < MQ; ++i) {
      float od[K];
      int oi[K];
#pragma unroll
      for (int s = 0; s < K; ++s) {
        od[s] = __shfl_xor_sync(0xffffffffu, bd[i][s], off, TX);
        oi[s] = __shfl_xor_sync(0xffffffffu, bi[i][s], off, TX);
      }
#pragma unroll
      for (int s = 0; s < K; ++s) insert<K>(bd[i], bi[i], od[s], oi[s]);
    }
  }
  if (G == 1) {
    if (tx == 0) {
#pragma unroll
      for (int i = 0; i < MQ; ++i) {
        const int qi = q0 + ty * MQ + i;
        if (qi < Q)
#pragma unroll
          for (int s = 0; s < K; ++s) {
            out_d[(size_t)qi * K + s] = bd[i][s];
            out_i[(size_t)qi * K + s] = bi[i][s];
          }
      }
    }
    return;
  }
  if (tx == 0) {
#pragma unroll
    for (int i = 0; i < MQ; ++i)
#pragma unroll
      for (int s = 0; s < K; ++s) {
        res_d[g][ty * MQ + i][s] = bd[i][s];
        res_i[g][ty * MQ + i][s] = bi[i][s];
      }
  }
  __syncthreads();
  if (threadIdx.x < TQ) {
    const int row = threadIdx.x, qi = q0 + row;
    float md[K];
    int mi[K];
#pragma unroll
    for (int s = 0; s < K; ++s) {
      md[s] = res_d[0][row][s];
      mi[s] = res_i[0][row][s];
    }
#pragma unroll
    for (int h = 1; h < G; ++h)
#pragma unroll
      for (int s = 0; s < K; ++s)
        insert<K>(md, mi, res_d[h][row][s], res_i[h][row][s]);
    if (qi < Q)
#pragma unroll
      for (int s = 0; s < K; ++s) {
        out_d[(size_t)qi * K + s] = md[s];
        out_i[(size_t)qi * K + s] = mi[s];
      }
  }
}

template <int G>
void launch(const float* a, const float* b, const unsigned char* bmask,
            float* out_d, int* out_i, int Q, int C, int D, int k,
            cudaStream_t stream) {
  const dim3 grid((Q + Tile<G>::TQ - 1) / Tile<G>::TQ);
  if (k == 1)
    chisq_topk_kernel<G, 1><<<grid, THREADS, 0, stream>>>(a, b, bmask, out_d,
                                                          out_i, Q, C, D);
  else if (k == 2)
    chisq_topk_kernel<G, 2><<<grid, THREADS, 0, stream>>>(a, b, bmask, out_d,
                                                          out_i, Q, C, D);
  else
    chisq_topk_kernel<G, 3><<<grid, THREADS, 0, stream>>>(a, b, bmask, out_d,
                                                          out_i, Q, C, D);
}

}  // namespace

// a [Q, D], b [C, D] f32, bmask [C] u8, 1 <= k <= 3, k <= C
// -> out_d [Q, k] f32 ascending, out_i [Q, k] i32
PCD_EXPORT int pcd_chisq_topk(const void* a, const void* b, const void* bmask,
                              void* out_d, void* out_i, int Q, int C, int D,
                              int k, void* stream) {
  if (Q == 0) return pcd_last_error();
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  // the smallest group count that gives >= 2 CTAs per SM
  int G = 1;
  while (G < 4 && (Q + 32 / G - 1) / (32 / G) < 2 * sms) G *= 2;
  const auto* pa = (const float*)a;
  const auto* pb = (const float*)b;
  const auto* pm = (const unsigned char*)bmask;
  auto* pd = (float*)out_d;
  auto* pi = (int*)out_i;
  auto s = (cudaStream_t)stream;
  if (G == 1)
    launch<1>(pa, pb, pm, pd, pi, Q, C, D, k, s);
  else if (G == 2)
    launch<2>(pa, pb, pm, pd, pi, Q, C, D, k, s);
  else
    launch<4>(pa, pb, pm, pd, pi, Q, C, D, k, s);
  return pcd_last_error();
}
