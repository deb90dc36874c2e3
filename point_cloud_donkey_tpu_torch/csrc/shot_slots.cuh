// PCL's quadrilinear SHOT binning of one in-radius (keypoint, point) pair,
// shared by K3 and K7 (shot_fused.cu, SHOT-352) and K8 (shot_hist.cu, the
// two channels of CSHOT-1344): the one binning source of the port's CUDA
// kernels.
//
// A pair's spatial half -- its volume and, for each of the radial,
// inclination and azimuth interpolations, its term of the central weight,
// its neighbour volume and its weight -- is computed once (shot_spatial).
// Each channel then soft-bins its own value into five slots around it
// (shot_channel): SHOT and CSHOT's shape channel the cosine, (1 + cos) * 5
// over 10 bins; CSHOT's colour channel the colour distance, cdist * 30
// over 30 bins.  The float operations and their order are those of the
// plain twins in ops/shot.py (`_spatial`, `_soft_bin`, `shot_bin_slots`,
// `cshot_slot_arrays`); the build's -fmad=false keeps every a * b + c as
// two roundings, as the twins compute them.
#pragma once

namespace shot {

constexpr int NR_BINS = 10;             // cosine bins (11 slots a volume)
constexpr int NR_COLOR_BINS = 30;       // colour bins (31 slots a volume)
constexpr int NR_SECTORS = 32;          // spatial volumes
constexpr int NB = NR_BINS + 1;
constexpr int NBC = NR_COLOR_BINS + 1;
constexpr int DESC = NR_SECTORS * NB;            // 352
constexpr int CDESC = DESC + NR_SECTORS * NBC;   // 1344, shape channel first
constexpr int SLOTS = 5;

constexpr float RAD_45 = (float)(3.14159265358979323846 / 4.0);
constexpr float RAD_90 = (float)(3.14159265358979323846 / 2.0);
constexpr float RAD_135 = (float)(3.0 * 3.14159265358979323846 / 4.0);
constexpr float RAD_PI_7_8 = (float)(3.14159265358979323846 * 7.0 / 8.0);

// The spatial half of one pair's binning.
struct Spatial {
  int desc;                      // the pair's volume
  float rad_c, incl_c, az_c;     // terms of the central weight, in order
  int rad_vol, incl_vol, az_vol; // neighbour volumes
  bool has_rad, has_incl, has_az;
  float rad_w, incl_w, az_w;     // neighbour weights
};

// The five weighted slots of one channel; idx is -1 where the pair has no
// such slot.
struct Slots {
  int idx[SLOTS];
  float w[SLOTS];
};

__device__ __forceinline__ Spatial shot_spatial(float x_l, float y_l,
                                                float z_l, float d,
                                                float r_half, float r34,
                                                float r14) {
  Spatial s;
  const int bit4 = (y_l > 0.f) || (y_l == 0.f && x_l < 0.f);
  const bool bit3_cond = (x_l > 0.f) || (x_l == 0.f && y_l > 0.f);
  const int bit3 = bit3_cond ? 1 - bit4 : bit4;
  int desc = ((bit4 << 3) + (bit3 << 2)) << 1;
  const bool inner = (x_l * y_l > 0.f) || (x_l == 0.f);
  const int add4 = inner ? (fabsf(x_l) >= fabsf(y_l) ? 0 : 4)
                         : (fabsf(x_l) > fabsf(y_l) ? 4 : 0);
  desc += add4 + (z_l > 0.f ? 1 : 0);
  desc += d > r_half ? 2 : 0;
  s.desc = desc;

  // radial interpolation (adjacent shell)
  const float rd_out = (d - r34) / r_half;
  const float rd_in = (d - r14) / r_half;
  const bool outer = d > r_half;
  const float rd = outer ? rd_out : rd_in;
  s.has_rad = outer ? (d <= r34) : (d >= r14);
  s.rad_c = outer ? (d > r34 ? 1.0f - rd_out : 1.0f + rd_out)
                  : (d < r14 ? 1.0f + rd_in : 1.0f - rd_in);
  s.rad_w = s.has_rad ? fabsf(rd) : 0.f;
  s.rad_vol = desc + (outer ? -2 : 2);

  // inclination interpolation (adjacent elevation volume)
  const float incl_cos = fminf(fmaxf(z_l / d, -1.0f), 1.0f);
  const float incl = acosf(incl_cos);
  const bool lower = (incl > RAD_90) || (incl == RAD_90 && z_l <= 0.f);
  const float id_low = (incl - RAD_135) / RAD_90;
  const float id_up = (incl - RAD_45) / RAD_90;
  s.incl_c = lower ? (incl > RAD_135 ? 1.0f - id_low : 1.0f + id_low)
                   : (incl < RAD_45 ? 1.0f + id_up : 1.0f - id_up);
  s.has_incl = lower ? (incl <= RAD_135) : (incl >= RAD_45);
  s.incl_w = s.has_incl ? (lower ? fabsf(id_low) : fabsf(id_up)) : 0.f;
  s.incl_vol = desc + (lower ? 1 : -1);

  // azimuth interpolation (adjacent sector, +-4 mod 32)
  s.has_az = (x_l != 0.f) || (y_l != 0.f);
  const float azimuth = atan2f(y_l, x_l);
  const int sel = desc >> 2;
  float az_dist = (azimuth - (-RAD_PI_7_8 + RAD_45 * (float)sel)) / RAD_45;
  az_dist = fminf(fmaxf(az_dist, -0.5f), 0.5f);
  s.az_c = s.has_az ? 1.0f - fabsf(az_dist) : 0.f;
  s.az_vol = az_dist > 0.f ? (desc + 4) % NR_SECTORS
                           : (desc - 4 + NR_SECTORS) % NR_SECTORS;
  s.az_w = s.has_az ? fabsf(az_dist) : 0.f;
  return s;
}

// The five slots of a channel with nr_bins bins (nr_bins + 1 slots a
// volume) that soft-bins `value`: the central slot, whose weight is
// 1 - |bd| + rad_c + incl_c + az_c summed in that order, the value's
// neighbour bin (modulo nr_bins, like PCL), and the radial, inclination
// and azimuth neighbour volumes at the central bin.  Indices are within
// the channel's 32 * (nr_bins + 1) slots.
__device__ __forceinline__ Slots shot_channel(const Spatial& sp, float value,
                                              int nr_bins) {
  const int nb = nr_bins + 1;
  const int step = (int)floorf(value + 0.5f);
  const float bd = value - (float)step;
  float central_w = 1.0f - fabsf(bd);
  central_w += sp.rad_c;
  central_w += sp.incl_c;
  central_w += sp.az_c;
  const int nbr = bd > 0.f ? (step + 1) % nr_bins
                           : (step - 1 + nr_bins) % nr_bins;
  Slots s;
  s.idx[0] = sp.desc * nb + step;
  s.w[0] = central_w;
  s.idx[1] = sp.desc * nb + nbr;
  s.w[1] = fabsf(bd);
  s.idx[2] = sp.has_rad ? sp.rad_vol * nb + step : -1;
  s.w[2] = sp.rad_w;
  s.idx[3] = sp.has_incl ? sp.incl_vol * nb + step : -1;
  s.w[3] = sp.incl_w;
  s.idx[4] = sp.has_az ? sp.az_vol * nb + step : -1;
  s.w[4] = sp.az_w;
  return s;
}

// SHOT's five slots of one pair: the cosine channel, (1 + cos) * 5.
__device__ __forceinline__ Slots shot_slots(float x_l, float y_l, float z_l,
                                            float cos_desc, float d,
                                            float r_half, float r34,
                                            float r14) {
  return shot_channel(shot_spatial(x_l, y_l, z_l, d, r_half, r34, r14),
                      (1.0f + cos_desc) * (NR_BINS / 2.0f), NR_BINS);
}

}  // namespace shot
