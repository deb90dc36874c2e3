// K3: SHOT-352 histograms over tile-compacted keypoints, and K7: the same
// over the dense [B, K] keypoint grid.
//
// K3 replaces point_cloud_donkey_tpu/ops/pallas/shot_fused.py
// `_shot_fused_call_windowed` over `_shot_tile_body`, reached through
// `shot_descriptor_fused_compact` (slab = the tile's whole cloud).
// K7 replaces `_shot_fused_call`, reached through `shot_descriptor_fused`
// (the mean-shift serving and detection path).
//
// For each tile of 8 keypoints (all of one cloud) and every point of that
// cloud with 1e-15 < |p - q|^2 <= r^2, a finite normal and mask set: the
// local-frame coordinates (p - q) . axis, the PCL volume bit pattern, and
// the quadrilinear soft binning of ops/shot.py (cosine, radial, inclination,
// azimuth) -- five weighted slots into the keypoint's 32 x 11 histogram
// (shot_slots.cuh, shared with K8).  The raw histogram and the in-radius
// count are written out; the wrapper normalises and sets validity.
//
// What bounds them on the H100: arithmetic on the in-radius pairs.  A
// 128-cloud batch has ~1.2e4 compacted keypoints x 2048 points ~ 2.5e7
// pairs, of which ~18% lie within r = 0.6 at the bench geometry; an
// in-radius pair costs ~100 fp32 operations with sqrtf, acosf and atan2f
// and five histogram adds, a pair outside only the gate.  Inputs are ~3 MB.
// K7's detection grid (32 clouds x 192 rows, ~2950 of them live) has
// ~6e6 live pairs, the same ~18% in radius.
// A cell grid would not prune: at r = 0.6 the cells around a keypoint cover
// most of a ~1.8-unit cloud.
// Design (K3 and K7, one kernel templated on how a tile finds its rows and
// cloud): one CTA per 8-keypoint tile, one warp per keypoint.
//   1-2. pairs::sweep (radius_pairs.cuh, shared with K8 and K9): the CTA
//      stages its cloud 1024 points at a time (x, y, z and the normal,
//      24 KB; ~40 KB with the histograms and queues, so four CTAs share an
//      SM), dropping masked points and points with a non-finite normal, in
//      index order; each warp gates the staged points for its keypoint with
//      the twin's float operations and queues the in-radius ones, and
//      whenever 32 are queued all 32 lanes bin one each: the
//      ~300-instruction body runs on full warps, and a pair outside the
//      radius costs only the gate.
//   3. The warp owns its keypoint's [352] histogram in shared memory, so no
//      other warp adds to it.  The five slots of a batch enter it in slot
//      order (pairs::warp_add); within a slot the lanes that hit one bin
//      (__match_any_sync) sum their weights in lane order by shuffles, and
//      the lowest of them adds the sum with a plain load and store.  The
//      batches are the in-radius points of each chunk in index order, 32
//      at a time, so every sum's order depends only on the inputs: two
//      launches give equal bits.  The count is the sum of the warp's ballot
//      popcounts.
// K3's tiles are compacted (tile t: rows t*8 .. t*8+7, all of cloud
// tile_cloud[t]); its dead rows (keypoints at 1e9) meet no point and come
// out zero.  K7's are the dense [B, K] grid's, ceil(K / 8) a cloud (tile t
// of cloud b: rows b*K + t*8 + k, t*8 + k < K), as K8's: a warp whose row
// is not live (live[row] false: an invalid frame or a padded keypoint,
// ~52% of the detection grid) stages with its CTA but bins nothing, and a
// CTA with no live row writes its zeros and exits.  Every row of hist and
// count is written, and no float is added atomically: one CTA owns a tile
// and sweeps its whole cloud.  acosf and atan2f stay full precision: the
// bin edges and weights are the twin's.
#include "common.cuh"
#include "radius_pairs.cuh"
#include "shot_slots.cuh"

namespace {

using shot::DESC;
using shot::shot_slots;
using shot::SLOTS;
using ShotSlots = shot::Slots;

constexpr int TK = pairs::TK;            // keypoints per tile
constexpr int THREADS = pairs::THREADS;  // one warp per keypoint
constexpr int CH = 1024;   // points staged per chunk (x, y, z, normal)

struct TileSmem {
  pairs::Staged<CH, 6> st;
  float h[TK][DESC];              // warp k's histogram
};

// Where warp k of CTA blk describes: its output row, the row's cloud,
// whether the row exists (ok) and whether it is binned (gate).
struct TileRow {
  size_t row, cloud;
  bool ok, gate;
};

// K3: tile blk holds rows blk*8 .. blk*8+7, all of cloud tile_cloud[blk];
// every row is binned (dead rows sit at 1e9 and meet no point).
struct CompactTiles {
  const int* __restrict__ tile_cloud;
  __device__ __forceinline__ TileRow at(int blk, int k) const {
    return {(size_t)blk * TK + k, (size_t)tile_cloud[blk], true, true};
  }
};

// K7: CTA blk is tile blk % tiles of cloud blk / tiles in the dense
// [B, K] grid; row b*K + t*8 + k exists when t*8 + k < K and is binned
// when live.
struct DenseTiles {
  const unsigned char* __restrict__ live;
  int K, tiles;
  __device__ __forceinline__ TileRow at(int blk, int k) const {
    const int b = blk / tiles;
    const int kk = (blk % tiles) * TK + k;
    const bool ok = kk < K;
    const size_t row = (size_t)b * K + kk;
    return {row, (size_t)b, ok, ok && live[row] != 0};
  }
};

// One CTA per tile, warp k describes its row k: compacted in-radius pairs
// binned into a warp-owned histogram (pairs::sweep, pairs::warp_add).
template <class Tiles>
__global__ void __launch_bounds__(THREADS, 4)
shot_tile_kernel(const float* __restrict__ kp, const float* __restrict__ fr,
                 Tiles tiles, const float* __restrict__ points,
                 const float* __restrict__ normals,
                 const unsigned char* __restrict__ mask,
                 float* __restrict__ hist, int* __restrict__ count, int N,
                 float rad) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  TileSmem& sm = *reinterpret_cast<TileSmem*>(smem_raw);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const TileRow tr = tiles.at(blockIdx.x, warp);
  float* out = hist + tr.row * DESC;
  if (!__syncthreads_or(tr.gate)) {   // uniform over the CTA
    if (tr.ok) {
      for (int e = lane; e < DESC; e += 32) out[e] = 0.f;
      if (lane == 0) count[tr.row] = 0;
    }
    return;
  }
  const float r2 = rad * rad;
  const float r_half = rad / 2.0f;
  const float r34 = 3.0f * rad / 4.0f;
  const float r14 = rad / 4.0f;
  float f[12] = {};   // frame rows x, y, z (9) + keypoint (3)
  if (tr.gate) {
#pragma unroll
    for (int c = 0; c < 9; ++c) f[c] = fr[tr.row * 9 + c];
#pragma unroll
    for (int c = 0; c < 3; ++c) f[9 + c] = kp[tr.row * 3 + c];
  }
  float* h = sm.h[warp];
  for (int e = lane; e < DESC; e += 32) h[e] = 0.f;

  const size_t b = tr.cloud;
  const float* const src[2] = {points + b * N * 3, normals + b * N * 3};
  const float (&v)[6][CH] = sm.st.v;
  // bin one batch: lane l holds staged point j (when act); the five slots
  // enter h in slot order, each by pairs::warp_add
  auto bin_batch = [&](int j, bool act) {
    ShotSlots s;
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
      s = shot_slots(x_l, y_l, z_l, cos_desc, sqrtf(d2), r_half, r34, r14);
    } else {
#pragma unroll
      for (int i = 0; i < SLOTS; ++i) {
        s.idx[i] = -1;
        s.w[i] = 0.f;
      }
    }
#pragma unroll
    for (int i = 0; i < SLOTS; ++i) pairs::warp_add(h, s.idx[i], s.w[i]);
  };
  const int cnt = pairs::sweep<CH, 6, true>(sm.st, src, mask + b * N, N,
                                            tr.gate, f[9], f[10], f[11], r2,
                                            bin_batch);
  __syncwarp();
  if (tr.ok) {
    for (int e = lane; e < DESC; e += 32) out[e] = h[e];
    if (lane == 0) count[tr.row] = cnt;
  }
}

// Launch shot_tile_kernel<Tiles> over `ctas` tiles (the first launch of
// each instance on a device raises its dynamic shared memory limit).
template <class Tiles>
int launch_tiles(const void* kp, const void* frames, Tiles tiles, int ctas,
                 const void* points, const void* normals, const void* mask,
                 void* hist, void* count, int N, float r, void* stream) {
  if (ctas == 0) return pcd_last_error();
  const int smem = (int)sizeof(TileSmem);
  const auto kernel = shot_tile_kernel<Tiles>;
  int dev = 0;
  cudaGetDevice(&dev);
  static bool smem_set[64] = {};   // one table per instance
  if (dev >= 64 || !smem_set[dev]) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    if (dev < 64) smem_set[dev] = true;
  }
  kernel<<<ctas, THREADS, smem, (cudaStream_t)stream>>>(
      (const float*)kp, (const float*)frames, tiles, (const float*)points,
      (const float*)normals, (const unsigned char*)mask, (float*)hist,
      (int*)count, N, r);
  return pcd_last_error();
}

}  // namespace

// kp [T*8, 3], frames [T*8, 9] (rows x, y, z axes), tile_cloud [T] i32,
// points / normals [B, N, 3] f32, mask [B, N] u8
// -> hist [T*8, 352] f32 (raw, volume-major), count [T*8] i32
PCD_EXPORT int pcd_shot_fused(const void* kp, const void* frames,
                              const void* tile_cloud, const void* points,
                              const void* normals, const void* mask,
                              void* hist, void* count, int T, int N, float r,
                              void* stream) {
  return launch_tiles(kp, frames, CompactTiles{(const int*)tile_cloud}, T,
                      points, normals, mask, hist, count, N, r, stream);
}

// kp [B*K, 3], frames [B*K, 9] (rows x, y, z axes), live [B*K] u8 (rows to
// describe), points / normals [B, N, 3] f32, mask [B, N] u8
// -> hist [B*K, 352] f32 (raw, volume-major), count [B*K] i32; every
// element is written, rows that are not live zero.
PCD_EXPORT int pcd_shot_dense(const void* kp, const void* frames,
                              const void* live, const void* points,
                              const void* normals, const void* mask,
                              void* hist, void* count, int B, int K, int N,
                              float r, void* stream) {
  const int tiles = (K + TK - 1) / TK;
  return launch_tiles(kp, frames,
                      DenseTiles{(const unsigned char*)live, K, tiles},
                      B * tiles, points, normals, mask, hist, count, N, r,
                      stream);
}
