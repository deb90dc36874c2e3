// K4: exact chi-square distances with a fused running top-k (k <= 3).
//
// Replaces point_cloud_donkey_tpu/ops/pallas/chisq.py `_chisq_call`
// (`chi_square_distance_matrix_pallas`), the flann::ChiSquareDistance
// matrix d(a, b) = sum_i (a_i - b_i)^2 / (a_i + b_i) over terms with
// a_i + b_i > 0, followed -- here in the same kernel -- by the k nearest
// codewords of `ops/neighbors.knn` (masked codewords at +inf, ties to the
// lower index as lax.top_k gives them).
//
// What bounds it on the H100: the IEEE division.  The serving batch has
// ~1.2e4 descriptors x 458 codewords x 352 dims ~ 1.9e9 terms, each an
// add, a subtract, a multiply and a correctly rounded division (no
// __fdividef, no fast math: they would move distances by ulps and reorder
// near-tied neighbours).  Bytes are negligible (the codebook is 0.6 MB and
// stays in L2).
// Design: one CTA per 16 descriptors, 256 threads as a 16 x 16 grid of
// (descriptor, codeword) pairs.  Codeword tiles of 16 stream through shared
// memory in 64-dim chunks beside the descriptor tile (rows padded to 65
// floats so the 16 codeword rows fall in distinct banks); each thread sums
// its pair's terms in a register, the 16 x 16 tile of distances goes to
// shared memory, and one thread per descriptor merges the tile into its
// running top-k in index order.  The [Q, C] matrix never reaches device
// memory: only [Q, k] distances and indices are written (the 2-sigma gate
// and the matching weight of the vote tail read the distances).
#include <climits>
#include <cmath>

#include "common.cuh"

namespace {

constexpr int CQ = 16;   // descriptors per CTA
constexpr int CC = 16;   // codewords per tile
constexpr int CD = 64;   // dims per shared-memory chunk
constexpr int THREADS = CQ * CC;
constexpr int KMAX = 3;

__device__ __forceinline__ bool before(float d, int i, float bd, int bi) {
  return d < bd || (d == bd && i < bi);
}

__global__ void __launch_bounds__(THREADS)
chisq_topk_kernel(const float* __restrict__ a, const float* __restrict__ b,
                  const unsigned char* __restrict__ bmask,
                  float* __restrict__ out_d, int* __restrict__ out_i, int Q,
                  int C, int D, int k) {
  __shared__ float sa[CQ][CD + 1];
  __shared__ float sb[CC][CD + 1];
  __shared__ float sdist[CQ][CC];
  const int tq = threadIdx.x / CC;
  const int tc = threadIdx.x % CC;
  const int q0 = blockIdx.x * CQ;

  float best_d[KMAX];
  int best_i[KMAX];
#pragma unroll
  for (int s = 0; s < KMAX; ++s) {
    best_d[s] = INFINITY;
    best_i[s] = INT_MAX;
  }

  for (int c0 = 0; c0 < C; c0 += CC) {
    float acc = 0.f;
    for (int d0 = 0; d0 < D; d0 += CD) {
      __syncthreads();
      for (int e = threadIdx.x; e < CQ * CD; e += THREADS) {
        const int r = e / CD, dd = e % CD, d = d0 + dd;
        const int qi = q0 + r, ci = c0 + r;
        sa[r][dd] = (qi < Q && d < D) ? a[(size_t)qi * D + d] : 0.f;
        sb[r][dd] = (ci < C && d < D) ? b[(size_t)ci * D + d] : 0.f;
      }
      __syncthreads();
#pragma unroll 8
      for (int dd = 0; dd < CD; ++dd) {
        const float x = sa[tq][dd], y = sb[tc][dd];
        const float s = x + y;
        if (s > 0.f) {
          const float diff = x - y;
          acc += diff * diff / s;
        }
      }
    }
    const int ci = c0 + tc;
    sdist[tq][tc] = (ci < C && bmask[ci]) ? acc : INFINITY;
    __syncthreads();
    if (tc == 0) {
      const int n = min(CC, C - c0);
      for (int j = 0; j < n; ++j) {
        const float d = sdist[tq][j];
        const int i = c0 + j;
        if (!before(d, i, best_d[k - 1], best_i[k - 1])) continue;
        int pos = k - 1;
        while (pos > 0 && before(d, i, best_d[pos - 1], best_i[pos - 1])) {
          best_d[pos] = best_d[pos - 1];
          best_i[pos] = best_i[pos - 1];
          --pos;
        }
        best_d[pos] = d;
        best_i[pos] = i;
      }
    }
  }
  const int qi = q0 + tq;
  if (tc == 0 && qi < Q) {
    for (int s = 0; s < k; ++s) {
      out_d[(size_t)qi * k + s] = best_d[s];
      out_i[(size_t)qi * k + s] = best_i[s];
    }
  }
}

}  // namespace

// a [Q, D], b [C, D] f32, bmask [C] u8, 1 <= k <= 3, k <= C
// -> out_d [Q, k] f32 ascending, out_i [Q, k] i32
PCD_EXPORT int pcd_chisq_topk(const void* a, const void* b, const void* bmask,
                              void* out_d, void* out_i, int Q, int C, int D,
                              int k, void* stream) {
  if (Q == 0) return pcd_last_error();
  chisq_topk_kernel<<<(Q + CQ - 1) / CQ, THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)a, (const float*)b, (const unsigned char*)bmask,
      (float*)out_d, (int*)out_i, Q, C, D, k);
  return pcd_last_error();
}
