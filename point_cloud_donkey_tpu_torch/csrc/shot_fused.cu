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
// azimuth) -- five weighted slots into the keypoint's 32 x 11 histogram.
// The raw histogram and the in-radius count are written out; the wrapper
// normalises and sets validity.
//
// What bounds them on the H100: arithmetic and shared-memory atomics.  A
// 128-cloud batch has ~1.2e4 compacted keypoints x 2048 points ~ 2.5e7 pairs;
// each in-radius pair costs ~100 fp32 operations with acosf and atan2f and
// five shared-memory atomicAdds.  Inputs are ~3 MB.
// Design (K3): one CTA per 8-keypoint tile, 256 threads; the tile reads its
// cloud's points by cloud id straight from global memory (L2-resident: the
// whole batch is a few MB), each thread strides over points and loops over
// the 8 keypoints, whose frames sit in shared memory.  Each keypoint has a
// [352] f32 shared-memory histogram (11 KB per CTA) that the five slots
// enter with atomicAdd; nothing [K, N]-sized or one-hot ever exists.  No
// TPU layout tricks (lane packing, 1e9 parking, slab pre-gather,
// block-diagonal one-hot dots) survive: masks are explicit, atan2f/acosf
// replace the polynomial approximations.
// Design (K7): on the TPU the grid's point axis runs in order and the tile
// accumulates in VMEM; Hopper runs blocks in no order, so the point sweep
// is split into `chunks` ranges across CTAs (grid = tiles x chunks; the
// wrapper picks chunks so that the grid fills about two waves of the SMs,
// which a 32-cloud batch's 768 tiles do with one chunk; smaller batches
// split further).  Each CTA bins its range into the same shared-memory
// histograms as K3 and then adds them into the zeroed output with global
// atomicAdd.  Rows whose frame is invalid are skipped (their descriptor is
// invalid whatever its histogram), and a tile with no live row exits at
// once: about 45% of the dense grid is padding at the bench geometry.
#include "common.cuh"

namespace {

constexpr int TK = 8;          // keypoints per tile
constexpr int NR_BINS = 10;
constexpr int NR_SECTORS = 32;
constexpr int NB = NR_BINS + 1;
constexpr int DESC = NR_SECTORS * NB;  // 352
constexpr int THREADS = 256;

constexpr float RAD_45 = (float)(3.14159265358979323846 / 4.0);
constexpr float RAD_90 = (float)(3.14159265358979323846 / 2.0);
constexpr float RAD_135 = (float)(3.0 * 3.14159265358979323846 / 4.0);
constexpr float RAD_PI_7_8 = (float)(3.14159265358979323846 * 7.0 / 8.0);

__device__ __forceinline__ void shot_bin_pair(
    float* __restrict__ h, float x_l, float y_l, float z_l, float cos_desc,
    float d, float r_half, float r34, float r14) {
  const float bin_dist = (1.0f + cos_desc) * (NR_BINS / 2.0f);
  const int step = (int)floorf(bin_dist + 0.5f);
  const float bd = bin_dist - (float)step;

  const int bit4 = (y_l > 0.f) || (y_l == 0.f && x_l < 0.f);
  const bool bit3_cond = (x_l > 0.f) || (x_l == 0.f && y_l > 0.f);
  const int bit3 = bit3_cond ? 1 - bit4 : bit4;
  int desc = ((bit4 << 3) + (bit3 << 2)) << 1;
  const bool inner = (x_l * y_l > 0.f) || (x_l == 0.f);
  const int add4 = inner ? (fabsf(x_l) >= fabsf(y_l) ? 0 : 4)
                         : (fabsf(x_l) > fabsf(y_l) ? 4 : 0);
  desc += add4 + (z_l > 0.f ? 1 : 0);
  desc += d > r_half ? 2 : 0;

  float central_w = 1.0f - fabsf(bd);
  const int cos_bin = bd > 0.f ? (step + 1) % NR_BINS
                               : (step - 1 + NR_BINS) % NR_BINS;
  const float cos_w = fabsf(bd);

  // radial interpolation (adjacent shell)
  const float rd_out = (d - r34) / r_half;
  const float rd_in = (d - r14) / r_half;
  const bool outer = d > r_half;
  const float rd = outer ? rd_out : rd_in;
  const bool has_rad = outer ? (d <= r34) : (d >= r14);
  central_w += outer ? (d > r34 ? 1.0f - rd_out : 1.0f + rd_out)
                     : (d < r14 ? 1.0f + rd_in : 1.0f - rd_in);
  const float rad_w = has_rad ? fabsf(rd) : 0.f;
  const int rad_vol = desc + (outer ? -2 : 2);

  // inclination interpolation (adjacent elevation volume)
  const float incl_cos = fminf(fmaxf(z_l / d, -1.0f), 1.0f);
  const float incl = acosf(incl_cos);
  const bool lower = (incl > RAD_90) || (incl == RAD_90 && z_l <= 0.f);
  const float id_low = (incl - RAD_135) / RAD_90;
  const float id_up = (incl - RAD_45) / RAD_90;
  central_w += lower ? (incl > RAD_135 ? 1.0f - id_low : 1.0f + id_low)
                     : (incl < RAD_45 ? 1.0f + id_up : 1.0f - id_up);
  const bool has_incl = lower ? (incl <= RAD_135) : (incl >= RAD_45);
  const float incl_w = has_incl ? (lower ? fabsf(id_low) : fabsf(id_up)) : 0.f;
  const int incl_vol = desc + (lower ? 1 : -1);

  // azimuth interpolation (adjacent sector, +-4 mod 32)
  const bool has_az = (x_l != 0.f) || (y_l != 0.f);
  const float azimuth = atan2f(y_l, x_l);
  const int sel = desc >> 2;
  float az_dist = (azimuth - (-RAD_PI_7_8 + RAD_45 * (float)sel)) / RAD_45;
  az_dist = fminf(fmaxf(az_dist, -0.5f), 0.5f);
  central_w += has_az ? 1.0f - fabsf(az_dist) : 0.f;
  const int az_vol = az_dist > 0.f ? (desc + 4) % NR_SECTORS
                                   : (desc - 4 + NR_SECTORS) % NR_SECTORS;
  const float az_w = has_az ? fabsf(az_dist) : 0.f;

  atomicAdd(h + desc * NB + step, central_w);
  atomicAdd(h + desc * NB + cos_bin, cos_w);
  if (has_rad) atomicAdd(h + rad_vol * NB + step, rad_w);
  if (has_incl) atomicAdd(h + incl_vol * NB + step, incl_w);
  if (has_az) atomicAdd(h + az_vol * NB + step, az_w);
}

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
      shot_bin_pair(sh[k], x_l, y_l, z_l, cos_desc, sqrtf(d2), r_half, r34,
                    r14);
    }
  }
#pragma unroll
  for (int k = 0; k < TK; ++k)
    if (cnt[k]) atomicAdd(&scount[k], cnt[k]);
}

__global__ void __launch_bounds__(THREADS)
shot_fused_kernel(const float* __restrict__ kp, const float* __restrict__ fr,
                  const int* __restrict__ tile_cloud,
                  const float* __restrict__ points,
                  const float* __restrict__ normals,
                  const unsigned char* __restrict__ mask,
                  float* __restrict__ hist, int* __restrict__ count, int N,
                  float rad) {
  __shared__ float sh[TK][DESC];
  __shared__ float sk[TK][12];   // frame rows x, y, z (9) + keypoint (3)
  __shared__ int scount[TK];
  const int t = blockIdx.x;
  load_tile(sh, sk, scount, kp, fr, (size_t)t * TK);
  __syncthreads();

  const int b = tile_cloud[t];
  sweep_points(sh, sk, scount, 0xFFu, points + (size_t)b * N * 3,
               normals + (size_t)b * N * 3, mask + (size_t)b * N, 0, N, rad);
  __syncthreads();

  float* out = hist + (size_t)t * TK * DESC;
  for (int e = threadIdx.x; e < TK * DESC; e += THREADS) out[e] = sh[e / DESC][e % DESC];
  if (threadIdx.x < TK) count[(size_t)t * TK + threadIdx.x] = scount[threadIdx.x];
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
  shot_fused_kernel<<<T, THREADS, 0, (cudaStream_t)stream>>>(
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
