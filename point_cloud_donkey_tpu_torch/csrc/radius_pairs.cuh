// The radius sweep shared by K3 (shot_fused.cu), K8 (shot_hist.cu) and K9
// (histogram.cu): one CTA of TK warps describes TK keypoints of one cloud,
// one warp a keypoint.
//   1. The CTA stages its cloud in shared memory CH points at a time (x, y,
//      z and NF - 3 more floats a point, from NF / 3 [N, 3] arrays),
//      dropping masked points -- and, with FINITE1, points whose second
//      array (the normal) is not finite -- as it stages.  The staged points
//      keep their index order (ballots and a scan of the warps' counts).
//   2. Each warp gates the staged points for its keypoint q, GATE a lane a
//      round, with the plain twins' float operations (1e-15 < |p - q|^2 <=
//      r^2 on exact differences), and pushes the in-radius ones into its
//      own queue in index order (__ballot_sync, __popc).  Whenever 32 are
//      queued, all 32 lanes bin one each through the caller's body: the
//      body runs on full warps, and a pair outside the radius costs only
//      the gate.  A chunk's partial batch is binned before the next chunk.
// The batches are the in-radius points of each chunk in index order, 32 at
// a time, so a body that adds in a fixed order gives equal bits on every
// launch.
#pragma once

namespace pairs {

constexpr int TK = 8;                  // keypoints (warps) per CTA
constexpr int THREADS = TK * 32;
constexpr int GATE = 4;                // points a lane gates per round
constexpr int QLEN = 32 * (GATE + 1);  // a warp's queue: < 32 left over
                                       // + a round's 32 * GATE
constexpr unsigned FULL = 0xffffffffu;

template <int CH, int NF>
struct Staged {
  float v[NF][CH];          // the chunk's usable points, index order
  int queue[TK][QLEN];      // warp k's in-radius points (staged ids)
  int wcount[TK];
};

// Stage points [base, base + n) of the cloud: those with the mask set (and
// a finite second array with FINITE1), in index order.  Every thread of
// the CTA calls; returns the number staged.
template <int CH, int NF, bool FINITE1>
__device__ int stage_chunk(Staged<CH, NF>& sm,
                           const float* const (&src)[NF / 3],
                           const unsigned char* __restrict__ mb, int base,
                           int n) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int total = 0;
  for (int j0 = 0; j0 < n; j0 += THREADS) {
    const int j = base + j0 + threadIdx.x;
    float v[NF] = {};
    bool keep = false;
    if (j0 + threadIdx.x < n && mb[j]) {
#pragma unroll
      for (int c = 0; c < NF; ++c) v[c] = src[c / 3][(size_t)j * 3 + c % 3];
      keep = !FINITE1 || (isfinite(v[3]) && isfinite(v[4]) && isfinite(v[5]));
    }
    const unsigned bal = __ballot_sync(FULL, keep);
    if (lane == 0) sm.wcount[warp] = __popc(bal);
    __syncthreads();
    int off = total;
#pragma unroll
    for (int w = 0; w < TK; ++w) {
      const int c = sm.wcount[w];
      off += w < warp ? c : 0;
      total += c;
    }
    if (keep) {
      const int pos = off + __popc(bal & ((1u << lane) - 1u));
#pragma unroll
      for (int c = 0; c < NF; ++c) sm.v[c][pos] = v[c];
    }
    __syncthreads();
  }
  return total;
}

// Sweep the cloud (N points) for the warp's keypoint (qx, qy, qz): every
// thread of the CTA calls (the staging has CTA-wide barriers); warps with
// `gate` false (warp-uniform) stage but bin nothing.  body(j, act) bins one
// batch, lane l holding staged point j when act.  Returns the warp's
// in-radius count (the same in every lane).
template <int CH, int NF, bool FINITE1, class Body>
__device__ __forceinline__ int sweep(Staged<CH, NF>& sm,
                                     const float* const (&src)[NF / 3],
                                     const unsigned char* __restrict__ mb,
                                     int N, bool gate, float qx, float qy,
                                     float qz, float r2, Body&& body) {
  const int lane = threadIdx.x & 31;
  int* queue = sm.queue[threadIdx.x >> 5];
  int cnt = 0;
  for (int base = 0; base < N; base += CH) {
    const int ns = stage_chunk<CH, NF, FINITE1>(sm, src, mb, base,
                                                min(CH, N - base));
    if (gate) {
      int qn = 0;   // queued, the same in every lane
      for (int j0 = 0; j0 < ns; j0 += 32 * GATE) {
        bool use[GATE];
#pragma unroll
        for (int u = 0; u < GATE; ++u) {
          const int j = j0 + 32 * u + lane;
          use[u] = false;
          if (j < ns) {
            const float dx = sm.v[0][j] - qx, dy = sm.v[1][j] - qy,
                        dz = sm.v[2][j] - qz;
            const float d2 = dx * dx + dy * dy + dz * dz;
            use[u] = d2 <= r2 && d2 > 1e-15f;
          }
        }
#pragma unroll
        for (int u = 0; u < GATE; ++u) {
          const unsigned bal = __ballot_sync(FULL, use[u]);
          if (use[u])
            queue[qn + __popc(bal & ((1u << lane) - 1u))] = j0 + 32 * u + lane;
          qn += __popc(bal);
          cnt += __popc(bal);
        }
        while (qn >= 32) {   // bin the first 32 queued, move the rest down
          __syncwarp();
          const int jb = queue[lane];
          const int rest = qn - 32;
          int moved[GATE];
#pragma unroll
          for (int u = 0; u < GATE; ++u)
            moved[u] = lane + 32 * u < rest ? queue[32 * (u + 1) + lane] : 0;
          __syncwarp();
#pragma unroll
          for (int u = 0; u < GATE; ++u)
            if (lane + 32 * u < rest) queue[32 * u + lane] = moved[u];
          __syncwarp();
          qn = rest;
          body(jb, true);
        }
      }
      if (qn > 0) {   // the chunk's last, partial batch
        __syncwarp();
        const int jb = lane < qn ? queue[lane] : 0;
        body(jb, lane < qn);
      }
    }
    __syncthreads();   // the next chunk restages the points
  }
  return cnt;
}

// Add one slot of a batch to the warp-owned histogram h: the lanes whose
// key hits one bin (__match_any_sync) sum their weights in lane order by
// shuffles, and the lowest of them adds the sum with a plain load and
// store; a key < 0 adds nothing.  The order depends only on the inputs.
__device__ __forceinline__ void warp_add(float* h, int key, float w) {
  const int lane = threadIdx.x & 31;
  const unsigned peers = __match_any_sync(FULL, key);
  const int first = __ffs(peers) - 1;
  float sum = __shfl_sync(FULL, w, first);
  unsigned m = key >= 0 ? peers & (peers - 1u) : 0u;
  while (__any_sync(FULL, m != 0u)) {
    const float v = __shfl_sync(FULL, w, m ? __ffs(m) - 1 : lane);
    if (m) {
      sum += v;
      m &= m - 1u;
    }
  }
  if (key >= 0 && lane == first) h[key] += sum;
  __syncwarp();
}

}  // namespace pairs
