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
// What bounds them on the H100: arithmetic on the pairs swept.  A pair
// costs ~10 fp32 operations for the gate and an in-radius pair ~21 more and
// a sqrt (K1) or ~6 (K2).  At the serving normals (128 clouds, r = 0.25)
// only ~3% of the 5.4e8 (query, point) pairs are in radius, so the least
// work is the in-radius pairs'; the bytes are a few MB.
//
// K1 and K2 share one design, a cell-binned sweep templated on its body
// (MomentsBody, VotesBody), its grid built inside each CTA.  A CTA of 512
// threads takes one cloud and a tile of its queries; the host uses as few
// tiles per cloud as fill one wave of two CTAs per SM (B = 128: 2 tiles;
// B = 32: 8), since every CTA rebuilds its cloud's grid.  The CTA
//   1. reads the cloud once from device memory, staging it in shared memory
//      as float4 (2048 points: 32 KB), reduces the bounding box of its
//      unmasked points and lays a uniform grid over it: cell edges
//      >= 1.01 r / 2 where at most 2048 such cells cover the box, else
//      >= 1.01 r (the 1% covers float rounding of the cell coordinates and
//      of the gate), the largest axis shrinking until the table fits
//      (edges only grow, so the sweep stays exact and a large extent costs
//      only speed); an empty, infinite or NaN extent is one cell;
//   2. sorts its queries by cell (a counting sort in shared memory), so the
//      lanes of a warp walk nearly the same cells;
//   3. bins the unmasked points with a counting sort -- shared-memory
//      counts, a block scan, then one warp scatters in point order with
//      __match_any_sync, so every cell keeps its points in index order --
//      and sweeps, for each query, the rows of cells around its cell: 3 x 3
//      rows of 3 cells with edges r, 5 x 5 rows of 5 with edges r / 2 (58%
//      of the volume), each row a contiguous run of the sorted points;
//      every point within r of the query lies there.  The gate is the
//      twins' float operations.  S lanes share a query (S = 1 at the
//      serving normals, up to 32 when a CTA has few queries), striding
//      through each run; a fixed shuffle tree sums them.  The order of
//      every sum depends only on the cloud and S (fixed by B and Q), so two
//      launches give equal bits.
// The bodies: K1 adds the moments of an in-radius point (the weight's sqrt
// is sqrt.approx, ~1 ulp, far inside the moments contract); K2 reads the
// query's two axis candidates by its original row and counts the signs of
// (p - q) . axis, integer sums that are exact in any order.
// Masked points never enter the grid (their coordinates may be garbage or
// NaN).  Cell coordinates are clamped in float before conversion; a query
// a neighbourhood or more outside the grid (a 1e9 pad, NaN) visits nothing
// and gets 0.  Results go back to each query's own row.  Clouds over 2048
// points are binned and swept chunk by chunk.  No PyTorch launch surrounds
// the kernels.
// K5 and K6 sweep every pair of their windows: one CTA per
// (cloud, tile of 128 queries), one thread per query, the window's points
// streamed through shared memory in 1024-point chunks as float4 (x, y, z,
// mask).  The 3x3 EVD between the two passes stays in PyTorch.
#include <cfloat>

#include "common.cuh"

namespace {

constexpr int TQ = 128;   // queries per windowed CTA (one thread each)
constexpr int TN = 1024;  // points staged in shared memory per chunk
constexpr int TQW = 256;  // queries per window-plan tile (2 CTAs)
static_assert(TQW % TQ == 0, "a CTA must lie inside one plan tile");

// Sweep range [lo, hi) of this CTA's queries: the window its plan tile was
// given (starts [B, T], clamped to N).
__device__ __forceinline__ void window_range(const int* __restrict__ starts,
                                             int T, int W, int N, int& lo,
                                             int& hi) {
  lo = starts[(size_t)blockIdx.y * T + (blockIdx.x * TQ) / TQW];
  lo = max(0, min(lo, N));
  hi = min(lo + W, N);
}

__device__ __forceinline__ void stage_points(float4* sp, const float* pb,
                                             const unsigned char* mb,
                                             int base, int n) {
  for (int j = threadIdx.x; j < n; j += blockDim.x) {
    const float* pp = pb + (size_t)(base + j) * 3;
    sp[j] = make_float4(pp[0], pp[1], pp[2], mb[base + j] ? 1.f : 0.f);
  }
}

__global__ void __launch_bounds__(TQ)
lrf_moments_windowed_kernel(const float* __restrict__ q,
                            const float* __restrict__ p,
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
  window_range(starts, T, W, N, lo, hi);
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

__global__ void __launch_bounds__(TQ)
sign_votes_windowed_kernel(const float* __restrict__ q,
                           const float* __restrict__ p,
                           const unsigned char* __restrict__ mask,
                           const int* __restrict__ starts,
                           const float* __restrict__ axes,
                           int* __restrict__ votes, int Q, int N, int T,
                           int W, float r, int z_only) {
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
  window_range(starts, T, W, N, lo, hi);
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

// ---- K1 / K2: the cell-binned radius sweep ---------------------------------

constexpr int KT = 512;            // threads of a binned CTA
constexpr int NCH = 2048;          // points binned per chunk
constexpr int QCAP = 1024;         // most queries of a CTA
constexpr int CELL_CAP = 2048;     // most cells of a cloud's grid
constexpr float CELL_MARGIN = 1.01f;  // cell edge >= 1.01 r: float slack
constexpr unsigned FULL = 0xffffffffu;

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
  float4 pts[NCH];           // its unmasked points in cell order
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
// otherwise sm.raw holds them already (w: 1 unmasked, 0 masked).
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
        sm.pts[pos] = make_float4(v.x, v.y, v.z, 0.f);
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

  __device__ __forceinline__ void begin(Acc& a, size_t, bool) const {
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

  __device__ __forceinline__ void begin(Acc& a, size_t row,
                                        bool active) const {
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

// One CTA per (cloud, tile of tq queries); S lanes per query (a power of
// two <= 32) share its sweep, striding through each run of points.
template <class Body>
__global__ void __launch_bounds__(KT, 2)
binned_sweep_kernel(const float* __restrict__ q, const float* __restrict__ p,
                    const unsigned char* __restrict__ mask, Body body, int Q,
                    int N, int tq, int S, float r) {
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
  const bool one_chunk = N <= NCH;

  // 1. the bounding box of the cloud's unmasked points (staging the cloud
  // when it fits one chunk) and the grid over it
  float lo[3] = {INFINITY, INFINITY, INFINITY};
  float hi[3] = {-INFINITY, -INFINITY, -INFINITY};
  for (int j = tid; j < N; j += KT) {
    const float* pp = pb + (size_t)j * 3;
    const float v[3] = {pp[0], pp[1], pp[2]};
    const bool m = mb[j] != 0;
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
    make_grid(sm.grid, lo, hi, r);
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
  if (one_chunk) bin_chunk(sm, g, pb, mb, 0, N, false);

  // 3. rounds of KT / S queries: each sweeps the (2f + 1)^2 rows of 2f + 1
  // consecutive cells around its cell (runs of the sorted points; every
  // point within r lies there), its S lanes striding through each run,
  // then a fixed shuffle tree sums the lanes
  const int sub = tid % S;
  for (int r0 = 0; r0 < nq; r0 += KT / S) {
    const int slot = r0 + tid / S;
    const bool active = slot < nq;
    float qx = 0.f, qy = 0.f, qz = 0.f;
    int row = 0, x0 = 0, x1 = -1, y0 = 0, y1 = -1, z0 = 0, z1 = -1;
    if (active) {
      const float4 mq = sm.q[slot];
      qx = mq.x; qy = mq.y; qz = mq.z;
      row = __float_as_int(mq.w);
      int c[3];
      if (query_cell(qx, qy, qz, g, c)) {
        x0 = max(c[0] - g.f, 0); x1 = min(c[0] + g.f, g.n[0] - 1);
        y0 = max(c[1] - g.f, 0); y1 = min(c[1] + g.f, g.n[1] - 1);
        z0 = max(c[2] - g.f, 0); z1 = min(c[2] + g.f, g.n[2] - 1);
      }
    }
    typename Body::Acc acc;
    body.begin(acc, (size_t)b * Q + q0 + row, active);
    for (int base = 0; base < N; base += NCH) {
      if (!one_chunk) bin_chunk(sm, g, pb, mb, base, min(NCH, N - base), true);
      for (int cz = z0; cz <= z1; ++cz)
        for (int cy = y0; cy <= y1; ++cy) {
          const int rc = (cz * g.n[1] + cy) * g.n[0];
          const int je = sm.start[rc + x1 + 1];
          for (int j = sm.start[rc + x0] + sub; j < je; j += S) {
            const float4 pt = sm.pts[j];
            const float dx = qx - pt.x, dy = qy - pt.y, dz = qz - pt.z;
            const float d2 = dx * dx + dy * dy + dz * dz;
            if (d2 <= r2) body.add(acc, pt, dx, dy, dz, d2);
          }
        }
      if (!one_chunk) __syncthreads();   // the next chunk reuses sm.pts
    }
    body.reduce(acc, S);
    if (active && sub == 0) body.write(acc, (size_t)b * Q + q0 + row);
  }
}

// Launch a binned sweep: as few CTAs per cloud as fill one wave of two
// CTAs per SM (each CTA builds its cloud's grid), at least 16 and at most
// QCAP queries a CTA; lanes per query: the most that still fit a CTA's
// threads.
template <class Body>
int launch_binned(const void* q, const void* p, const void* mask, Body body,
                  int B, int Q, int N, float r, void* stream) {
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
  static bool smem_set[64] = {};   // one table per body
  if (dev >= 64 || !smem_set[dev]) {
    cudaFuncSetAttribute(binned_sweep_kernel<Body>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (dev < 64) smem_set[dev] = true;
  }
  dim3 grid((Q + tq - 1) / tq, B);
  binned_sweep_kernel<Body><<<grid, KT, smem, (cudaStream_t)stream>>>(
      (const float*)q, (const float*)p, (const unsigned char*)mask, body, Q,
      N, tq, lanes, r);
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
  dim3 grid((Q + TQ - 1) / TQ, B);
  lrf_moments_windowed_kernel<<<grid, TQ, 0, (cudaStream_t)stream>>>(
      (const float*)q, (const float*)p, (const unsigned char*)mask,
      (const int*)starts, (float*)mom, (int*)count, Q, N, T, W, r);
  return pcd_last_error();
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

// as pcd_sign_votes over the windows of pcd_lrf_moments_windowed
PCD_EXPORT int pcd_sign_votes_windowed(const void* q, const void* p,
                                       const void* mask, const void* starts,
                                       const void* axes, void* votes, int B,
                                       int Q, int N, int T, int W, float r,
                                       int z_only, void* stream) {
  dim3 grid((Q + TQ - 1) / TQ, B);
  sign_votes_windowed_kernel<<<grid, TQ, 0, (cudaStream_t)stream>>>(
      (const float*)q, (const float*)p, (const unsigned char*)mask,
      (const int*)starts, (const float*)axes, (int*)votes, Q, N, T, W, r,
      z_only);
  return pcd_last_error();
}

PCD_EXPORT const char* pcd_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
