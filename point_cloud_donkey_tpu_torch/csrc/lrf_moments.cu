// K1 radius moments and K2 sign votes of the SHOT local reference frame,
// their windowed forms K5 and K6, and their v2 forms K10 and K11.
//
// Replaces point_cloud_donkey_tpu/ops/pallas/lrf_moments.py `_moments_call`
// (K1) and `_sign_votes_call` (K2), reached through `shot_lrf_pallas`,
// `_moments_call_gathered` (K5) and `_sign_votes_call_gathered` (K6),
// reached through `shot_lrf_pallas_windowed`, `_moments_call_v2` (K10) and
// `_sign_votes_call_v2` (K11), which `_moments_dispatch` and
// `_sign_votes_dispatch` select under PCD_PALLAS_LRF_V=2 (K11 without
// z_only).
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
// K10: K1's sums with the matmul-identity gate d2 = (|q|^2 + |p|^2) -
// 2 q.p, the weight r - sqrt(max(d2, 0)) ("shot") or 1 ("uniform"), and
// every moment as the TPU kernel's bf16x3 product w_hi F_hi + w_hi F_lo +
// w_lo F_hi, where x_hi = bf16(x) and x_lo = bf16(x - x_hi).
// K11: K2's counts (both candidates) under K10's identity gate, the vote
// a.p - a.q >= 0 (not K2's (p - q) . a: the two differ at ties), a.q once
// per query.
//
// What bounds them on the H100: arithmetic on the pairs swept.  A pair
// costs ~10 fp32 operations for the gate and an in-radius pair ~21 more and
// a sqrt (K1), ~6 (K2) or ~85 (K10: ten bf16 splits, two to a conversion,
// and thirty products, twenty of them fused with their sums) or ~14 (K11:
// two dots, each with a subtraction and a compare).
// At the serving normals (128 clouds, r = 0.25) only ~3% of the 5.4e8
// (query, point) pairs are in radius, so the least work is the in-radius
// pairs'; the bytes are a few MB.
//
// K1, K2, K5, K6, K10 and K11 share one design, a cell-binned sweep
// templated on its body (MomentsBody, VotesBody, MomentsV2Body,
// VotesV2Body), its gate (the exact difference, or K10's and K11's
// identity) and its point range (the whole cloud, or
// K5's and K6's windows), its grid built inside each CTA.  A CTA of 512
// threads takes one cloud and a tile of its queries; the host uses as few
// tiles per cloud as fill one wave of two CTAs per SM (B = 128: 2 tiles;
// B = 32: 8), since every CTA rebuilds its cloud's grid.  The CTA
//   1. reads its points once from device memory -- the cloud, or for K5
//      and K6 the union of the windows of the plan tiles its queries lie in
//      (a contiguous range of the sorted points) -- staging them in shared
//      memory as float4 (2048 points: 32 KB), reduces the bounding box of
//      the unmasked ones and lays a uniform grid over it: cell edges
//      >= 1.01 r / 2 where at most 2048 such cells cover the box, else
//      >= 1.01 r (the 1% covers float rounding of the cell coordinates and
//      of the gate), the largest axis shrinking until the table fits
//      (edges only grow, so the sweep stays exact and a large extent costs
//      only speed); an empty, infinite or NaN extent is one cell.  Under
//      the identity gate the edges cover r^2 + 2^-19 (P^2 + r^2), P^2 the
//      box's largest |p|^2: the identity's rounding (~6 ulp of |q|^2 +
//      |p|^2) can pass a pair that far, and the sweep must visit it;
//   2. sorts its queries by cell (a counting sort in shared memory), so the
//      lanes of a warp walk nearly the same cells;
//   3. bins the unmasked points with a counting sort -- shared-memory
//      counts, a block scan, then one warp scatters in point order with
//      __match_any_sync, so every cell keeps its points in index order --
//      and sweeps, for each query, the rows of cells around its cell: 3 x 3
//      rows of 3 cells with edges r, 5 x 5 rows of 5 with edges r / 2 (58%
//      of the volume), each row a contiguous run of the sorted points;
//      every point within r of the query lies there.  The gate is the
//      twins' float operations (K10, K11: |q|^2 once per query, |p|^2
//      staged in the sorted point's fourth word, both in the twin's
//      order).  K5 and K6 skip the points outside a query's own tile
//      window: the sorted point's fourth word holds its index, and a point
//      within r but outside the window stays out, as in the TPU kernel.  S
//      lanes share a query (S = 1 at the serving normals, up to 32 when a
//      CTA has few queries), striding through each run; a fixed shuffle
//      tree sums them.
//      The order of every sum depends only on the points swept and S (fixed
//      by B and Q), so two launches give equal bits.
// The bodies: K1 adds the moments of an in-radius point (the weight's sqrt
// is sqrt.approx, ~1 ulp, far inside the moments contract); K2 reads the
// query's two axis candidates by its original row and counts the signs of
// (p - q) . axis, integer sums that are exact in any order; K10 splits the
// weight and the nine point features into bf16 hi / lo parts in fp32
// registers and adds the three products of each moment, as the twin and
// the TPU kernel compute them (dropping the split would make K10 compute
// K1's function).  A product of two bf16 values is exact in fp32, so K10
// fuses two of them with their sums (fmaf) without changing a bit.  Its
// body is ~4x K1's and a warp runs it whenever one lane's pair is in
// radius, so K10 takes ~2x K1's time: the split, not the sweep, is its
// cost.  A per-lane queue that ran the body with more lanes busy cost as
// much in its flattened loop as it saved.  K10 uses no tensor cores: the
// binned sweep gives each query its own runs of points, so a 16-query x
// 16-point weight tile would be ~97% zeros at the normals radius --
// multiplying zeros is the work the sweep exists to skip -- and the gate
// would still run on the CUDA cores.
// K11, the sweep's sixth kernel, is K2's body (VotesV2Body) under K10's
// gate.  The identity gate passes the body no offset, so K11 votes on the
// exact coordinates: the query's as the sweep holds them (every body's
// begin gets them; K11 forms a.q there) and the staged point's x, y, z.
// It needs no other change to the sweep: the gate, its widened cells and
// the launch shape are K10's, and its sums are integers, exact in any
// order.  Its products and sums stay separate roundings (-fmad=false, no
// fmaf): unlike K10's bf16 products they are not exact, and the twin
// rounds each.  Its dots have depth 3, a sixteenth of an mma's, so they
// stay on the CUDA cores beside the gate.  A masked point never enters
// the grid; an unmasked non-finite one fails the gate, as in the twin.
// Masked points never enter the grid (their coordinates may be garbage or
// NaN).  Cell coordinates are clamped in float before conversion; a query
// a neighbourhood or more outside the grid (a 1e9 pad, NaN) visits nothing
// and gets 0.  Results go back to each query's own row.  Point ranges over
// 2048 points are binned and swept chunk by chunk.  No PyTorch launch
// surrounds the kernels.
#include <cfloat>
#include <cuda_bf16.h>

#include "common.cuh"

namespace {

constexpr int TQW = 256;  // queries per window-plan tile

// Points [lo, hi) of cloud b that plan tile t sweeps: the window it was
// given (starts [B, T], clamped to N).
__device__ __forceinline__ void plan_window(const int* __restrict__ starts,
                                            int b, int t, int T, int W,
                                            int N, int& lo, int& hi) {
  lo = starts[(size_t)b * T + t];
  lo = max(0, min(lo, N));
  hi = min(lo + W, N);
}

// ---- K1 / K2 / K5 / K6 / K10: the cell-binned radius sweep ----------------

constexpr int KT = 512;            // threads of a binned CTA
constexpr int NCH = 2048;          // points binned per chunk
constexpr int QCAP = 1024;         // most queries of a CTA
constexpr int CELL_CAP = 2048;     // most cells of a cloud's grid
constexpr float CELL_MARGIN = 1.01f;  // cell edge >= 1.01 r: float slack
constexpr unsigned FULL = 0xffffffffu;

// The radius gate of a sweep: exact coordinate differences (K1, K2, K5,
// K6) or the matmul identity (|q|^2 + |p|^2) - 2 q.p (K10, K11).
enum Gate { EXACT_GATE, IDENTITY_GATE };

// A uniform grid over the bounding box of a cloud's unmasked points: cell
// (cx, cy, cz) has id (cz * n[1] + cy) * n[0] + cx, edges >= 1.01 r / f, so
// every point within r of a query lies within f cells of the query's cell
// on each axis.  An axis of one cell has lo = inv = 0, so every coordinate
// maps to cell 0 there.
struct CellGrid {
  float lo[3], inv[3];
  int n[3];
  int cells;
  int f;
};

struct BinnedSmem {
  float4 raw[NCH];           // the chunk's points in index order (w: cell)
  float4 pts[NCH];           // its unmasked points in cell order (w: the
                             // point's index; |p|^2 under the identity gate)
  int start[CELL_CAP + 1];   // first sorted point of each cell
  int cursor[CELL_CAP + 1];  // counts, then scatter cursors
  float4 q[QCAP];            // the CTA's queries in cell order (w: row)
  float red[6][KT / 32];
  int wsum[KT / 32];
  CellGrid grid;
};

// sqrt.approx (MUFU.SQRT, ~1 ulp): the weight r - d moves by ~1e-8, far
// inside the moments contract; the radius gate never reads it
__device__ __forceinline__ float sqrt_approx(float x) {
  float y;
  asm("sqrt.approx.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ int point_cell(float x, float y, float z,
                                          const CellGrid& g) {
  const float v[3] = {x, y, z};
  int c[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    // clamp in float before converting (NaN -> 0)
    float f = (v[k] - g.lo[k]) * g.inv[k];
    f = fminf(fmaxf(f, 0.f), (float)(g.n[k] - 1));
    c[k] = (int)f;
  }
  return (c[2] * g.n[1] + c[1]) * g.n[0] + c[0];
}

// A query's cell (each coordinate in [-f, n + f)); false when it lies f
// cells or more outside the grid (or is NaN): no point is within r of it.
__device__ __forceinline__ bool query_cell(float x, float y, float z,
                                           const CellGrid& g, int (&c)[3]) {
  const float v[3] = {x, y, z};
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float f = (v[k] - g.lo[k]) * g.inv[k];
    if (!(f >= (float)-g.f && f < (float)(g.n[k] + g.f))) return false;
    c[k] = (int)floorf(f);
  }
  return true;
}

// The sort key of a query: its cell clamped into the grid, or g.cells for
// a query that visits no cell.
__device__ __forceinline__ int query_key(float x, float y, float z,
                                         const CellGrid& g) {
  int c[3];
  if (!query_cell(x, y, z, g, c)) return g.cells;
#pragma unroll
  for (int k = 0; k < 3; ++k) c[k] = max(0, min(c[k], g.n[k] - 1));
  return (c[2] * g.n[1] + c[1]) * g.n[0] + c[0];
}

// Exclusive prefix sum of a[0, L) in place; every thread of the CTA calls.
__device__ void block_exclusive_scan(int* a, int L, int* wsum) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int per = (L + KT - 1) / KT;
  const int s = min(L, tid * per), e = min(L, s + per);
  int sum = 0;
  for (int i = s; i < e; ++i) sum += a[i];
  int incl = sum;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int v = __shfl_up_sync(FULL, incl, o);
    if (lane >= o) incl += v;
  }
  if (lane == 31) wsum[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const int v = lane < KT / 32 ? wsum[lane] : 0;
    int inc = v;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int u = __shfl_up_sync(FULL, inc, o);
      if (lane >= o) inc += u;
    }
    if (lane < KT / 32) wsum[lane] = inc - v;
  }
  __syncthreads();
  int run = wsum[warp] + incl - sum;
  for (int i = s; i < e; ++i) {
    const int v = a[i];
    a[i] = run;
    run += v;
  }
  __syncthreads();
}

// Thread 0: the grid of a cloud from its bounding box (lo, hi per axis):
// edges of r / 2 (a 5 x 5 x 5 neighbourhood, 58% of the 3 x 3 x 3 one's
// volume) where those cells fit the table, else edges of r.
__device__ __forceinline__ void make_grid(CellGrid& g, const float (&lo)[3],
                                          const float (&hi)[3], float r) {
  int n[3];
  for (int f = 2; f >= 1; --f) {
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const float ext = hi[k] - lo[k];
      const float nf = ext * (float)f / (r * CELL_MARGIN);
      // an empty, infinite or NaN extent, or one under two cells, is one
      // cell
      const bool finite = ext >= 0.f && ext <= FLT_MAX;
      n[k] = finite && nf >= 2.f ? (int)fminf(nf, (float)CELL_CAP) : 1;
    }
    g.f = f;
    if ((long long)n[0] * n[1] * n[2] <= CELL_CAP) break;
  }
  // shrink the largest axis until the table fits: edges only grow
  while ((long long)n[0] * n[1] * n[2] > CELL_CAP) {
    const int k = n[0] >= n[1] ? (n[0] >= n[2] ? 0 : 2) : (n[1] >= n[2] ? 1 : 2);
    n[k] = max(1, n[k] * 3 / 4);
  }
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    g.n[k] = n[k];
    g.lo[k] = n[k] > 1 ? lo[k] : 0.f;
    g.inv[k] = n[k] > 1 ? (float)n[k] / (hi[k] - lo[k]) : 0.f;
  }
  g.cells = n[0] * n[1] * n[2];
}

// Bin points [base, base + n) of the cloud into the cells: a counting sort
// (shared-memory counts, a block scan), then one warp scatters in point
// order, so every cell keeps its points in index order and two launches
// sum in the same order.  With stage, the points come from device memory;
// otherwise sm.raw holds them already (w: 1 unmasked, 0 masked).  Each
// sorted point keeps its index in w, or under the identity gate its |p|^2
// (the twin's (x x + y y) + z z).
template <int GATE>
__device__ void bin_chunk(BinnedSmem& sm, const CellGrid& g,
                          const float* __restrict__ pb,
                          const unsigned char* __restrict__ mb, int base,
                          int n, bool stage) {
  const int tid = threadIdx.x, lane = tid & 31;
  for (int i = tid; i <= g.cells; i += KT) sm.cursor[i] = 0;
  __syncthreads();
  for (int j = tid; j < n; j += KT) {
    float4 v;
    if (stage) {
      const float* pp = pb + (size_t)(base + j) * 3;
      v = make_float4(pp[0], pp[1], pp[2], mb[base + j] ? 1.f : 0.f);
    } else {
      v = sm.raw[j];
    }
    int c = -1;
    if (v.w != 0.f) {
      c = point_cell(v.x, v.y, v.z, g);
      atomicAdd(&sm.cursor[c], 1);
    }
    v.w = __int_as_float(c);
    sm.raw[j] = v;
  }
  __syncthreads();
  block_exclusive_scan(sm.cursor, g.cells + 1, sm.wsum);
  for (int i = tid; i <= g.cells; i += KT) sm.start[i] = sm.cursor[i];
  __syncthreads();
  if (tid < 32) {
    for (int j0 = 0; j0 < n; j0 += 32) {
      const int j = j0 + lane;
      const float4 v = j < n ? sm.raw[j] : make_float4(0.f, 0.f, 0.f, 0.f);
      const int c = j < n ? __float_as_int(v.w) : -1;
      const unsigned peers = __match_any_sync(FULL, c);
      const int rank = __popc(peers & ((1u << lane) - 1u));
      const int pos = c >= 0 ? sm.cursor[c] + rank : 0;
      __syncwarp();
      if (c >= 0) {
        const float w = GATE == IDENTITY_GATE
                            ? v.x * v.x + v.y * v.y + v.z * v.z
                            : __int_as_float(base + j);
        sm.pts[pos] = make_float4(v.x, v.y, v.z, w);
        if (rank == 0) sm.cursor[c] += __popc(peers);
      }
      __syncwarp();
    }
  }
  __syncthreads();
}

// K1's body: the (r - d)-weighted moments of the in-radius points and
// their count, written to mom [B*Q, 10] and count [B*Q].
struct MomentsBody {
  float* mom;
  int* count;
  float r;

  struct Acc {
    float s0, sx, sy, sz, xx, yy, zz, xy, xz, yz;
    int cnt;
  };

  __device__ __forceinline__ void begin(Acc& a, size_t, bool, float, float,
                                        float) const {
    a.s0 = a.sx = a.sy = a.sz = 0.f;
    a.xx = a.yy = a.zz = a.xy = a.xz = a.yz = 0.f;
    a.cnt = 0;
  }
  __device__ __forceinline__ void add(Acc& a, const float4& pt, float, float,
                                      float, float d2) const {
    const float w = r - sqrt_approx(d2);
    const float wx = w * pt.x, wy = w * pt.y, wz = w * pt.z;
    a.s0 += w; a.sx += wx; a.sy += wy; a.sz += wz;
    a.xx += wx * pt.x; a.yy += wy * pt.y; a.zz += wz * pt.z;
    a.xy += wx * pt.y; a.xz += wx * pt.z; a.yz += wy * pt.z;
    ++a.cnt;
  }
  __device__ __forceinline__ void reduce(Acc& a, int S) const {
    for (int o = S / 2; o > 0; o >>= 1) {
      a.s0 += __shfl_xor_sync(FULL, a.s0, o);
      a.sx += __shfl_xor_sync(FULL, a.sx, o);
      a.sy += __shfl_xor_sync(FULL, a.sy, o);
      a.sz += __shfl_xor_sync(FULL, a.sz, o);
      a.xx += __shfl_xor_sync(FULL, a.xx, o);
      a.yy += __shfl_xor_sync(FULL, a.yy, o);
      a.zz += __shfl_xor_sync(FULL, a.zz, o);
      a.xy += __shfl_xor_sync(FULL, a.xy, o);
      a.xz += __shfl_xor_sync(FULL, a.xz, o);
      a.yz += __shfl_xor_sync(FULL, a.yz, o);
      a.cnt += __shfl_xor_sync(FULL, a.cnt, o);
    }
  }
  __device__ __forceinline__ void write(const Acc& a, size_t o) const {
    float* m = mom + o * 10;
    m[0] = a.s0; m[1] = a.sx; m[2] = a.sy; m[3] = a.sz;
    m[4] = a.xx; m[5] = a.yy; m[6] = a.zz; m[7] = a.xy; m[8] = a.xz;
    m[9] = a.yz;
    count[o] = a.cnt;
  }
};

// K2's body: per query, the in-radius counts with (p - q) . axis >= 0 for
// its x (axes[row, 0:3]) and z (axes[row, 3:6]) candidates, written to
// votes [B*Q, 2] (x is 0 when z_only).
struct VotesBody {
  const float* axes;
  int* votes;
  int z_only;

  struct Acc {
    float vx, vy, vz, ux, uy, uz;
    int plus_x, plus_z;
  };

  __device__ __forceinline__ void begin(Acc& a, size_t row, bool active,
                                        float, float, float) const {
    a.vx = a.vy = a.vz = a.ux = a.uy = a.uz = 0.f;
    if (active) {
      const float* ax = axes + row * 6;
      a.vx = ax[0]; a.vy = ax[1]; a.vz = ax[2];
      a.ux = ax[3]; a.uy = ax[4]; a.uz = ax[5];
    }
    a.plus_x = a.plus_z = 0;
  }
  // the twins' float operations on the offset p - q (the sweep's q - p,
  // negated exactly)
  __device__ __forceinline__ void add(Acc& a, const float4&, float dx,
                                      float dy, float dz, float) const {
    const float ex = -dx, ey = -dy, ez = -dz;
    a.plus_z += (ex * a.ux + ey * a.uy + ez * a.uz) >= 0.f;
    if (!z_only) a.plus_x += (ex * a.vx + ey * a.vy + ez * a.vz) >= 0.f;
  }
  __device__ __forceinline__ void reduce(Acc& a, int S) const {
    for (int o = S / 2; o > 0; o >>= 1) {
      a.plus_x += __shfl_xor_sync(FULL, a.plus_x, o);
      a.plus_z += __shfl_xor_sync(FULL, a.plus_z, o);
    }
  }
  __device__ __forceinline__ void write(const Acc& a, size_t o) const {
    votes[o * 2] = a.plus_x;
    votes[o * 2 + 1] = a.plus_z;
  }
};

// K11's body: K2's counts and outputs (both candidates, never z_only) on
// the identity gate's pairs, where the sweep passes no offset: the vote is
// a.p - a.q >= 0 with a.q once per query, both dots in the twin's order
// (ax x + ay y) + az z on the exact coordinates (the query's as the sweep
// holds them, the staged point's x, y, z; its w is |p|^2 here).
struct VotesV2Body : VotesBody {
  struct Acc : VotesBody::Acc {
    float qv, qu;   // x and z candidates . q
  };

  __device__ __forceinline__ void begin(Acc& a, size_t row, bool active,
                                        float qx, float qy, float qz) const {
    VotesBody::begin(a, row, active, qx, qy, qz);
    a.qv = qx * a.vx + qy * a.vy + qz * a.vz;
    a.qu = qx * a.ux + qy * a.uy + qz * a.uz;
  }
  __device__ __forceinline__ void add(Acc& a, const float4& pt, float, float,
                                      float, float) const {
    a.plus_x += (pt.x * a.vx + pt.y * a.vy + pt.z * a.vz) - a.qv >= 0.f;
    a.plus_z += (pt.x * a.ux + pt.y * a.uy + pt.z * a.uz) - a.qu >= 0.f;
  }
};

// The bf16 hi / lo parts of a and b at once (cvt.rn.bf16x2.f32, round to
// nearest even as torch's float -> bfloat16): x_hi = bf16(x), x_lo =
// bf16(x - x_hi), as fp32.
__device__ __forceinline__ void bf16_split2(float a, float b, float& ah,
                                            float& al, float& bh, float& bl) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  ah = __low2float(h);
  bh = __high2float(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(a - ah, b - bh);
  al = __low2float(l);
  bl = __high2float(l);
}

// One moment term of an in-radius pair, w_hi F_hi + w_hi F_lo + w_lo F_hi
// in the twin's association.  Products of two bf16 values are exact in
// fp32, so each fused multiply-add rounds as the separate product and sum
// do.
__device__ __forceinline__ float split_term(float wh, float wl, float fh,
                                            float fl) {
  return __fmaf_rn(wl, fh, __fmaf_rn(wh, fl, wh * fh));
}

// K10's body: K1's sums and outputs, with the weight r - sqrt(max(d2, 0))
// (SHOT) or 1 (uniform) of the identity gate's d2, and every moment as the
// bf16x3 product of the weight and the point feature (1, x, y, z, xx, yy,
// zz, xy, xz, yz).
template <bool SHOT>
struct MomentsV2Body : MomentsBody {
  __device__ __forceinline__ void add(Acc& a, const float4& pt, float, float,
                                      float, float d2) const {
    const float w = SHOT ? r - sqrt_approx(fmaxf(d2, 0.f)) : 1.f;
    const float x = pt.x, y = pt.y, z = pt.z;
    float wh, wl, xh, xl, yh, yl, zh, zl;
    bf16_split2(w, x, wh, wl, xh, xl);
    bf16_split2(y, z, yh, yl, zh, zl);
    float h0, l0, h1, l1;
    a.s0 += wh + wl;   // the feature 1: hi 1, lo 0
    a.sx += split_term(wh, wl, xh, xl);
    a.sy += split_term(wh, wl, yh, yl);
    a.sz += split_term(wh, wl, zh, zl);
    bf16_split2(x * x, y * y, h0, l0, h1, l1);
    a.xx += split_term(wh, wl, h0, l0);
    a.yy += split_term(wh, wl, h1, l1);
    bf16_split2(z * z, x * y, h0, l0, h1, l1);
    a.zz += split_term(wh, wl, h0, l0);
    a.xy += split_term(wh, wl, h1, l1);
    bf16_split2(x * z, y * z, h0, l0, h1, l1);
    a.xz += split_term(wh, wl, h0, l0);
    a.yz += split_term(wh, wl, h1, l1);
    ++a.cnt;
  }
};

// One CTA per (cloud, tile of tq queries); S lanes per query (a power of
// two <= 32) share its sweep, striding through each run of points.  GATE
// picks the radius gate; WINDOWED sweeps, for each query, only the window
// of its plan tile (starts [B, T], W points each, clamped to N), else the
// whole cloud.
template <class Body, int GATE, bool WINDOWED>
__global__ void __launch_bounds__(KT, 2)
binned_sweep_kernel(const float* __restrict__ q, const float* __restrict__ p,
                    const unsigned char* __restrict__ mask,
                    const int* __restrict__ starts, Body body, int Q, int N,
                    int T, int W, int tq, int S, float r) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  BinnedSmem& sm = *reinterpret_cast<BinnedSmem*>(smem_raw);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.y;
  const int q0 = blockIdx.x * tq;
  const int nq = min(tq, Q - q0);
  if (nq <= 0) return;
  const float r2 = r * r;
  const float* pb = p + (size_t)b * N * 3;
  const unsigned char* mb = mask + (size_t)b * N;
  const float* qb = q + ((size_t)b * Q + q0) * 3;
  // the points the CTA sweeps, [pbeg, pend): the cloud, or the union of the
  // windows of the plan tiles its queries lie in
  int pbeg = 0, pend = N;
  if (WINDOWED) {
    pbeg = N;
    pend = 0;
    for (int t = q0 / TQW; t <= (q0 + nq - 1) / TQW; ++t) {
      int a, e;
      plan_window(starts, b, t, T, W, N, a, e);
      pbeg = min(pbeg, a);
      pend = max(pend, e);
    }
    pend = max(pend, pbeg);
  }
  const int span = pend - pbeg;
  const bool one_chunk = span <= NCH;

  // 1. the bounding box of the swept unmasked points (staging them when
  // they fit one chunk) and the grid over it
  float lo[3] = {INFINITY, INFINITY, INFINITY};
  float hi[3] = {-INFINITY, -INFINITY, -INFINITY};
  for (int j = tid; j < span; j += KT) {
    const float* pp = pb + (size_t)(pbeg + j) * 3;
    const float v[3] = {pp[0], pp[1], pp[2]};
    const bool m = mb[pbeg + j] != 0;
    if (one_chunk) sm.raw[j] = make_float4(v[0], v[1], v[2], m ? 1.f : 0.f);
    if (m)
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        lo[k] = fminf(lo[k], v[k]);
        hi[k] = fmaxf(hi[k], v[k]);
      }
  }
#pragma unroll
  for (int k = 0; k < 3; ++k)
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      lo[k] = fminf(lo[k], __shfl_xor_sync(FULL, lo[k], o));
      hi[k] = fmaxf(hi[k], __shfl_xor_sync(FULL, hi[k], o));
    }
  if (lane == 0)
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      sm.red[k][warp] = lo[k];
      sm.red[3 + k][warp] = hi[k];
    }
  __syncthreads();
  if (tid == 0) {
    for (int w = 1; w < KT / 32; ++w)
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        lo[k] = fminf(lo[k], sm.red[k][w]);
        hi[k] = fmaxf(hi[k], sm.red[3 + k][w]);
      }
    float reach = r;
    if (GATE == IDENTITY_GATE) {
      // the identity's rounding: |q|^2 + |p|^2 <= ~4 P^2 for any pair it
      // could pass, and ~6 ulp of that bounds its error
      float p2 = 0.f;
#pragma unroll
      for (int k = 0; k < 3; ++k)
        p2 += fmaxf(lo[k] * lo[k], hi[k] * hi[k]);
      reach = sqrtf(r * r + 0x1p-19f * (p2 + r * r));
    }
    make_grid(sm.grid, lo, hi, reach);
  }
  __syncthreads();
  const CellGrid g = sm.grid;

  // 2. the CTA's queries in cell order (a counting sort; bucket g.cells
  // holds those that visit no cell), so the lanes of a warp walk nearly
  // the same cells.  A query's sums do not depend on its slot.
  for (int i = tid; i <= g.cells; i += KT) sm.cursor[i] = 0;
  __syncthreads();
  for (int i = tid; i < nq; i += KT)
    atomicAdd(&sm.cursor[query_key(qb[i * 3], qb[i * 3 + 1], qb[i * 3 + 2],
                                   g)], 1);
  __syncthreads();
  block_exclusive_scan(sm.cursor, g.cells + 1, sm.wsum);
  for (int i = tid; i < nq; i += KT) {
    const float x = qb[i * 3], y = qb[i * 3 + 1], z = qb[i * 3 + 2];
    const int slot = atomicAdd(&sm.cursor[query_key(x, y, z, g)], 1);
    sm.q[slot] = make_float4(x, y, z, __int_as_float(i));
  }
  __syncthreads();
  if (one_chunk) bin_chunk<GATE>(sm, g, pb, mb, pbeg, span, false);

  // 3. rounds of KT / S queries: each sweeps the (2f + 1)^2 rows of 2f + 1
  // consecutive cells around its cell (runs of the sorted points; every
  // point within r lies there), its S lanes striding through each run,
  // then a fixed shuffle tree sums the lanes
  const int sub = tid % S;
  for (int r0 = 0; r0 < nq; r0 += KT / S) {
    const int slot = r0 + tid / S;
    const bool active = slot < nq;
    float qx = 0.f, qy = 0.f, qz = 0.f, qq = 0.f;
    int row = 0, x0 = 0, x1 = -1, y0 = 0, y1 = -1, z0 = 0, z1 = -1;
    int wlo = 0, whi = 0;
    if (active) {
      const float4 mq = sm.q[slot];
      qx = mq.x; qy = mq.y; qz = mq.z;
      row = __float_as_int(mq.w);
      if (GATE == IDENTITY_GATE) qq = qx * qx + qy * qy + qz * qz;
      if (WINDOWED)
        plan_window(starts, b, (q0 + row) / TQW, T, W, N, wlo, whi);
      int c[3];
      if (query_cell(qx, qy, qz, g, c)) {
        x0 = max(c[0] - g.f, 0); x1 = min(c[0] + g.f, g.n[0] - 1);
        y0 = max(c[1] - g.f, 0); y1 = min(c[1] + g.f, g.n[1] - 1);
        z0 = max(c[2] - g.f, 0); z1 = min(c[2] + g.f, g.n[2] - 1);
      }
    }
    typename Body::Acc acc;
    body.begin(acc, (size_t)b * Q + q0 + row, active, qx, qy, qz);
    for (int base = pbeg; base < pend; base += NCH) {
      if (!one_chunk)
        bin_chunk<GATE>(sm, g, pb, mb, base, min(NCH, pend - base), true);
      for (int cz = z0; cz <= z1; ++cz)
        for (int cy = y0; cy <= y1; ++cy) {
          const int rc = (cz * g.n[1] + cy) * g.n[0];
          const int je = sm.start[rc + x1 + 1];
          for (int j = sm.start[rc + x0] + sub; j < je; j += S) {
            const float4 pt = sm.pts[j];
            if (WINDOWED) {
              const int idx = __float_as_int(pt.w);
              if (idx < wlo || idx >= whi) continue;
            }
            if (GATE == IDENTITY_GATE) {
              const float qp = qx * pt.x + qy * pt.y + qz * pt.z;
              const float d2 = (qq + pt.w) - 2.f * qp;
              if (d2 <= r2) body.add(acc, pt, 0.f, 0.f, 0.f, d2);
            } else {
              const float dx = qx - pt.x, dy = qy - pt.y, dz = qz - pt.z;
              const float d2 = dx * dx + dy * dy + dz * dz;
              if (d2 <= r2) body.add(acc, pt, dx, dy, dz, d2);
            }
          }
        }
      if (!one_chunk) __syncthreads();   // the next chunk reuses sm.pts
    }
    body.reduce(acc, S);
    if (active && sub == 0) body.write(acc, (size_t)b * Q + q0 + row);
  }
}

// Launch a binned sweep: as few CTAs per cloud as fill one wave of two
// CTAs per SM (each CTA builds its grid), at least 16 and at most QCAP
// queries a CTA; lanes per query: the most that still fit a CTA's
// threads.  starts, T and W: the window plan of a WINDOWED sweep.
template <class Body, int GATE = EXACT_GATE, bool WINDOWED = false>
int launch_binned(const void* q, const void* p, const void* mask, Body body,
                  int B, int Q, int N, float r, void* stream,
                  const void* starts = nullptr, int T = 0, int W = 0) {
  if (B == 0 || Q == 0) return pcd_last_error();
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  int tiles = max(1, 2 * sms / B);
  tiles = min(tiles, (Q + 15) / 16);
  tiles = max(tiles, (Q + QCAP - 1) / QCAP);
  const int tq = (Q + tiles - 1) / tiles;
  int lanes = 1;
  while (lanes < 32 && 2 * lanes * tq <= KT) lanes *= 2;
  const int smem = (int)sizeof(BinnedSmem);
  const auto kernel = binned_sweep_kernel<Body, GATE, WINDOWED>;
  static bool smem_set[64] = {};   // one table per instance
  if (dev >= 64 || !smem_set[dev]) {
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         smem);
    if (dev < 64) smem_set[dev] = true;
  }
  dim3 grid((Q + tq - 1) / tq, B);
  kernel<<<grid, KT, smem, (cudaStream_t)stream>>>(
      (const float*)q, (const float*)p, (const unsigned char*)mask,
      (const int*)starts, body, Q, N, T, W, tq, lanes, r);
  return pcd_last_error();
}

}  // namespace

// q [B, Q, 3], p [B, N, 3] f32 (centroid-shifted), mask [B, N] u8
// -> mom [B, Q, 10] f32 (s0, s1 xyz, s2 xx yy zz xy xz yz), count [B, Q] i32
PCD_EXPORT int pcd_lrf_moments(const void* q, const void* p, const void* mask,
                               void* mom, void* count, int B, int Q, int N,
                               float r, void* stream) {
  return launch_binned(q, p, mask, MomentsBody{(float*)mom, (int*)count, r},
                       B, Q, N, r, stream);
}

// as pcd_lrf_moments over sorted points, each 256-query tile t of cloud b
// sweeping points [starts[b, t], starts[b, t] + W); starts [B, T] i32 with
// T = ceil(Q / 256)
PCD_EXPORT int pcd_lrf_moments_windowed(const void* q, const void* p,
                                        const void* mask, const void* starts,
                                        void* mom, void* count, int B, int Q,
                                        int N, int T, int W, float r,
                                        void* stream) {
  return launch_binned<MomentsBody, EXACT_GATE, true>(
      q, p, mask, MomentsBody{(float*)mom, (int*)count, r}, B, Q, N, r,
      stream, starts, T, W);
}

// as pcd_lrf_moments with the identity gate and bf16x3 moments; shot = 1
// for the (r - d) weights, 0 for uniform ones
PCD_EXPORT int pcd_lrf_moments_v2(const void* q, const void* p,
                                  const void* mask, void* mom, void* count,
                                  int B, int Q, int N, float r, int shot,
                                  void* stream) {
  const MomentsBody m{(float*)mom, (int*)count, r};
  if (shot)
    return launch_binned<MomentsV2Body<true>, IDENTITY_GATE>(
        q, p, mask, MomentsV2Body<true>{m}, B, Q, N, r, stream);
  return launch_binned<MomentsV2Body<false>, IDENTITY_GATE>(
      q, p, mask, MomentsV2Body<false>{m}, B, Q, N, r, stream);
}

// axes [B, Q, 6] f32 (x candidate, z candidate) -> votes [B, Q, 2] i32
// (in-radius counts with (p - q) . axis >= 0 for x, z; x is 0 when z_only)
PCD_EXPORT int pcd_sign_votes(const void* q, const void* p, const void* mask,
                              const void* axes, void* votes, int B, int Q,
                              int N, float r, int z_only, void* stream) {
  return launch_binned(q, p, mask,
                       VotesBody{(const float*)axes, (int*)votes, z_only}, B,
                       Q, N, r, stream);
}

// axes [B, Q, 6] f32 (x candidate, z candidate) -> votes [B, Q, 2] i32
// (counts, under the identity gate, with a.p - a.q >= 0 for x, z)
PCD_EXPORT int pcd_sign_votes_v2(const void* q, const void* p,
                                 const void* mask, const void* axes,
                                 void* votes, int B, int Q, int N, float r,
                                 void* stream) {
  return launch_binned<VotesV2Body, IDENTITY_GATE>(
      q, p, mask, VotesV2Body{{(const float*)axes, (int*)votes, 0}}, B, Q, N,
      r, stream);
}

// as pcd_sign_votes over the windows of pcd_lrf_moments_windowed
PCD_EXPORT int pcd_sign_votes_windowed(const void* q, const void* p,
                                       const void* mask, const void* starts,
                                       const void* axes, void* votes, int B,
                                       int Q, int N, int T, int W, float r,
                                       int z_only, void* stream) {
  return launch_binned<VotesBody, EXACT_GATE, true>(
      q, p, mask, VotesBody{(const float*)axes, (int*)votes, z_only}, B, Q,
      N, r, stream, starts, T, W);
}

PCD_EXPORT const char* pcd_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
