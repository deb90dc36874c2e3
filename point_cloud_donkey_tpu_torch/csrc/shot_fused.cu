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
// (shot_slots.cuh, shared by both kernels and K8).  The raw histogram and
// the in-radius count are written out; the wrapper normalises and sets
// validity.
//
// What bounds them on the H100: arithmetic on the in-radius pairs.  A
// 128-cloud batch has ~1.2e4 compacted keypoints x 2048 points ~ 2.5e7
// pairs, of which ~18% lie within r = 0.6 at the bench geometry; an
// in-radius pair costs ~100 fp32 operations with sqrtf, acosf and atan2f
// and five histogram adds, a pair outside only the gate.  Inputs are ~3 MB.
// A cell grid would not prune: at r = 0.6 the cells around a keypoint cover
// most of a ~1.8-unit cloud.
// Design (K3): one CTA per 8-keypoint tile, one warp per keypoint.
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
// Dead rows (keypoints at 1e9) meet no point and come out zero.  acosf and
// atan2f stay full precision: the bin edges and weights are the twin's.
// Design (K7): on the TPU the grid's point axis runs in order and the tile
// accumulates in VMEM; Hopper runs blocks in no order, so the point sweep
// is split into `chunks` ranges across CTAs (grid = tiles x chunks; the
// wrapper picks chunks so that the grid fills about two waves of the SMs,
// which a 32-cloud batch's 768 tiles do with one chunk; smaller batches
// split further).  Each CTA's 256 threads stride over its range, loop over
// the tile's 8 keypoints, and enter the five slots into shared-memory
// histograms with atomicAdd, then add them into the zeroed output with
// global atomicAdd.  Rows whose frame is invalid are skipped (their
// descriptor is invalid whatever its histogram), and a tile with no live
// row exits at once: about 45% of the dense grid is padding at the bench
// geometry.
#include "common.cuh"
#include "radius_pairs.cuh"
#include "shot_slots.cuh"

namespace {

using shot::DESC;
using shot::shot_slots;
using shot::SLOTS;
using ShotSlots = shot::Slots;

constexpr int TK = pairs::TK;            // keypoints per tile
constexpr int THREADS = pairs::THREADS;  // K3: one warp per keypoint

// ---- K3: compacted in-radius pairs into warp-owned histograms ----------------

constexpr int CH = 1024;   // points staged per chunk (x, y, z, normal)

struct TileSmem {
  pairs::Staged<CH, 6> st;
  float h[TK][DESC];              // warp k's histogram
};

// One CTA per tile t (rows t*8 .. t*8+7, all of cloud tile_cloud[t]); warp
// k describes row t*8 + k.
__global__ void __launch_bounds__(THREADS, 4)
shot_fused_kernel(const float* __restrict__ kp, const float* __restrict__ fr,
                  const int* __restrict__ tile_cloud,
                  const float* __restrict__ points,
                  const float* __restrict__ normals,
                  const unsigned char* __restrict__ mask,
                  float* __restrict__ hist, int* __restrict__ count, int N,
                  float rad) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  TileSmem& sm = *reinterpret_cast<TileSmem*>(smem_raw);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int t = blockIdx.x;
  const size_t row = (size_t)t * TK + warp;
  const float r2 = rad * rad;
  const float r_half = rad / 2.0f;
  const float r34 = 3.0f * rad / 4.0f;
  const float r14 = rad / 4.0f;
  float f[12];   // frame rows x, y, z (9) + keypoint (3)
#pragma unroll
  for (int c = 0; c < 9; ++c) f[c] = fr[row * 9 + c];
#pragma unroll
  for (int c = 0; c < 3; ++c) f[9 + c] = kp[row * 3 + c];
  float* h = sm.h[warp];
  for (int e = lane; e < DESC; e += 32) h[e] = 0.f;

  const size_t b = tile_cloud[t];
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
                                            true, f[9], f[10], f[11], r2,
                                            bin_batch);
  __syncwarp();
  float* out = hist + row * DESC;
  for (int e = lane; e < DESC; e += 32) out[e] = h[e];
  if (lane == 0) count[row] = cnt;
}

// ---- K7: the dense keypoint grid --------------------------------------------

// Load the tile's frames and keypoints (rows t*8 .. t*8+7) into sk, zero
// the histograms and counts.
__device__ __forceinline__ void load_tile(float (*sh)[DESC], float (*sk)[12],
                                          int* scount, const float* kp,
                                          const float* fr, size_t row0) {
  for (int e = threadIdx.x; e < TK * DESC; e += THREADS) sh[e / DESC][e % DESC] = 0.f;
  if (threadIdx.x < TK * 12) {
    const int k = threadIdx.x / 12, c = threadIdx.x % 12;
    const size_t row = row0 + k;
    sk[k][c] = c < 9 ? fr[row * 9 + c] : kp[row * 3 + (c - 9)];
  }
  if (threadIdx.x < TK) scount[threadIdx.x] = 0;
}

// Bin the points [j0, j1) of one cloud into the histograms of the tile's
// keypoints whose bit is set in `live`; in-radius counts go to scount.
__device__ __forceinline__ void sweep_points(
    float (*sh)[DESC], float (*sk)[12], int* scount, unsigned live,
    const float* __restrict__ pb, const float* __restrict__ nb,
    const unsigned char* __restrict__ mb, int j0, int j1, float rad) {
  const float r2 = rad * rad;
  const float r_half = rad / 2.0f;
  const float r34 = 3.0f * rad / 4.0f;
  const float r14 = rad / 4.0f;
  int cnt[TK];
#pragma unroll
  for (int k = 0; k < TK; ++k) cnt[k] = 0;

  for (int j = j0 + threadIdx.x; j < j1; j += THREADS) {
    if (!mb[j]) continue;
    const float nx = nb[j * 3 + 0], ny = nb[j * 3 + 1], nz = nb[j * 3 + 2];
    if (!(isfinite(nx) && isfinite(ny) && isfinite(nz))) continue;
    const float px = pb[j * 3 + 0], py = pb[j * 3 + 1], pz = pb[j * 3 + 2];
#pragma unroll
    for (int k = 0; k < TK; ++k) {
      if (!((live >> k) & 1u)) continue;
      const float* f = sk[k];
      const float dx = px - f[9], dy = py - f[10], dz = pz - f[11];
      const float d2 = dx * dx + dy * dy + dz * dz;
      if (!(d2 <= r2 && d2 > 1e-15f)) continue;
      ++cnt[k];
      const float x_l = dx * f[0] + dy * f[1] + dz * f[2];
      const float y_l = dx * f[3] + dy * f[4] + dz * f[5];
      const float z_l = dx * f[6] + dy * f[7] + dz * f[8];
      const float cos_desc =
          fminf(fmaxf(nx * f[6] + ny * f[7] + nz * f[8], -1.0f), 1.0f);
      const ShotSlots s = shot_slots(x_l, y_l, z_l, cos_desc, sqrtf(d2),
                                     r_half, r34, r14);
      atomicAdd(sh[k] + s.idx[0], s.w[0]);   // central and cosine: always
      atomicAdd(sh[k] + s.idx[1], s.w[1]);
#pragma unroll
      for (int i = 2; i < SLOTS; ++i)
        if (s.idx[i] >= 0) atomicAdd(sh[k] + s.idx[i], s.w[i]);
    }
  }
#pragma unroll
  for (int k = 0; k < TK; ++k)
    if (cnt[k]) atomicAdd(&scount[k], cnt[k]);
}

// K7: grid (tiles of the dense grid, point chunks).  Tile t holds rows
// t*8 .. t*8+7 of the [B*K] grid (K % 8 == 0, so a tile never spans
// clouds); chunk c sweeps points [c*S, min(N, (c+1)*S)) with S =
// ceil(N / chunks).  hist and count must be zeroed by the caller.
__global__ void __launch_bounds__(THREADS)
shot_dense_kernel(const float* __restrict__ kp, const float* __restrict__ fr,
                  const unsigned char* __restrict__ live,
                  const float* __restrict__ points,
                  const float* __restrict__ normals,
                  const unsigned char* __restrict__ mask,
                  float* __restrict__ hist, int* __restrict__ count, int K,
                  int N, float rad) {
  __shared__ float sh[TK][DESC];
  __shared__ float sk[TK][12];
  __shared__ int scount[TK];
  const int t = blockIdx.x;
  const size_t row0 = (size_t)t * TK;
  unsigned bits = 0;
#pragma unroll
  for (int k = 0; k < TK; ++k) bits |= live[row0 + k] ? (1u << k) : 0u;
  if (bits == 0) return;   // uniform over the CTA: no barrier is skipped
  const int span = (N + gridDim.y - 1) / gridDim.y;
  const int j0 = blockIdx.y * span;
  const int j1 = min(N, j0 + span);
  if (j0 >= j1) return;
  load_tile(sh, sk, scount, kp, fr, row0);
  __syncthreads();

  const size_t b = row0 / K;
  sweep_points(sh, sk, scount, bits, points + b * N * 3,
               normals + b * N * 3, mask + b * N, j0, j1, rad);
  __syncthreads();

  float* out = hist + row0 * DESC;
  for (int e = threadIdx.x; e < TK * DESC; e += THREADS) {
    const float v = sh[e / DESC][e % DESC];
    if (v != 0.f) atomicAdd(out + e, v);
  }
  if (threadIdx.x < TK && scount[threadIdx.x])
    atomicAdd(count + row0 + threadIdx.x, scount[threadIdx.x]);
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
  if (T == 0) return pcd_last_error();
  const int smem = (int)sizeof(TileSmem);
  int dev = 0;
  cudaGetDevice(&dev);
  static bool smem_set[64] = {};
  if (dev >= 64 || !smem_set[dev]) {
    cudaFuncSetAttribute(shot_fused_kernel,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (dev < 64) smem_set[dev] = true;
  }
  shot_fused_kernel<<<T, THREADS, smem, (cudaStream_t)stream>>>(
      (const float*)kp, (const float*)frames, (const int*)tile_cloud,
      (const float*)points, (const float*)normals,
      (const unsigned char*)mask, (float*)hist, (int*)count, N, r);
  return pcd_last_error();
}

// kp [B*K, 3], frames [B*K, 9] (rows x, y, z axes), live [B*K] u8 (rows to
// describe), points / normals [B, N, 3] f32, mask [B, N] u8; K % 8 == 0
// -> hist [B*K, 352] f32 (raw, volume-major), count [B*K] i32, both
// accumulated into (zero them first)
PCD_EXPORT int pcd_shot_dense(const void* kp, const void* frames,
                              const void* live, const void* points,
                              const void* normals, const void* mask,
                              void* hist, void* count, int B, int K, int N,
                              int chunks, float r, void* stream) {
  const int tiles = B * K / TK;
  if (tiles == 0 || N == 0) return pcd_last_error();
  dim3 grid(tiles, chunks);
  shot_dense_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)kp, (const float*)frames, (const unsigned char*)live,
      (const float*)points, (const float*)normals,
      (const unsigned char*)mask, (float*)hist, (int*)count, K, N, r);
  return pcd_last_error();
}
