"""Colour conversion: sRGB -> normalised CIELab, and the colour distance of
CSHOT (port of point_cloud_donkey_tpu/ops/color.py).

Spec: the reference's PCL colour conversion (color_conversion.cpp): sRGB
gamma expansion, D65 XYZ, the cube root through the 4000-entry LUT law
(index truncation included), L/a/b clamped to [0,100]/[-120,120] and
normalised by 100/120/120.  Distance: (|dL| + (|da| + |db|) / 2) / 3,
clamped to [0, 1] (color_conversion.cpp:86-96).

The LUT index floor(t * 4000) turns a last-ulp difference in t into a
whole LUT step (1e-4 or more in normalised Lab), so the port computes t
with the float operations of the JAX function as XLA compiles it for the
CPU (what the JAX serving step runs), not with the ones its source spells:
  * a division by a constant is a multiplication by the constant's f32
    reciprocal, and chains of constant factors fold into one f32 constant
    (x / 0.95047 * 4000 is x * (4000 * (1 / 0.95047)), each step in f32);
  * a product feeding a sum is one fused multiply-add, emulated exactly in
    float64: the product of two f32 values is exact there and the sum
    rounds once to float64, then once to float32;
  * x ** e is float64 pow(x, f32(e)) rounded to float32, which equals the
    JAX CPU result on all 256 byte values of the sRGB expansion and on all
    but at most two of the 4000 LUT entries (those differ by one ulp).
The float64 steps give the same bits on the CPU and on the GPU.
"""

from __future__ import annotations

import torch

from .kernels import f32


def _recip(c: float) -> float:
    """f32 reciprocal of the f32 constant c: what x / c compiles to."""
    return f32(1.0 / f32(c))


def _fold(a: float, b: float) -> float:
    """The f32 product of two f32 constants (XLA folds constant factors)."""
    return float(torch.tensor(a, dtype=torch.float32)
                 * torch.tensor(b, dtype=torch.float32))


def _fma(a: torch.Tensor, b, c) -> torch.Tensor:
    """f32 a * b + c with one rounding (a fused multiply-add)."""
    b = b.double() if isinstance(b, torch.Tensor) else f32(b)
    c = c.double() if isinstance(c, torch.Tensor) else f32(c)
    return (a.double() * b + c).float()


def _pow(x: torch.Tensor, e: float) -> torch.Tensor:
    return (x.double() ** f32(e)).float()


_LUT_STEP = _recip(4000.0)
_X_TO_LUT = _fold(4000.0, _recip(0.95047))
_Z_TO_LUT = _fold(4000.0, _recip(1.08883))
_LIN_SLOPE = _fold(7.787, _LUT_STEP)


def _srgb_expand(c: torch.Tensor) -> torch.Tensor:
    """c in [0, 1] (the reference indexes a 256-entry LUT by byte value)."""
    return torch.where(c > 0.04045, _pow((c + 0.055) * _recip(1.055), 2.4),
                       c * _recip(12.92))


def _xyz_f(t4000: torch.Tensor) -> torch.Tensor:
    """The reference's sXYZ_LUT law at t * 4000, including the index
    truncation: f = floor(t * 4000) / 4000, then f^0.3333 (PCL's power)
    or the linear branch 7.787 f + 16 / 116."""
    idx = torch.floor(torch.clamp(t4000, 0.0, 3999.0))
    f = idx * _LUT_STEP
    return torch.where(f > 0.008856, _pow(f, 0.3333),
                       _fma(idx, _LIN_SLOPE, 16.0 / 116.0))


def rgb_to_cielab_normalized(rgb: torch.Tensor) -> torch.Tensor:
    """rgb [..., 3] f32 in [0, 1] -> normalised Lab [..., 3]
    (0 <= L <= 1, -1 <= a, b <= 1)."""
    f = _srgb_expand(rgb)
    fr, fg, fb = f[..., 0], f[..., 1], f[..., 2]
    x = _fma(fb, 0.180423, _fma(fr, 0.412453, fg * 0.357580))
    y = _fma(fb, 0.072169, _fma(fr, 0.212671, fg * 0.715160))
    z = _fma(fb, 0.950227, _fma(fr, 0.019334, fg * 0.119193))

    vx = _xyz_f(x * _X_TO_LUT)
    vy = _xyz_f(y * 4000.0)
    vz = _xyz_f(z * _Z_TO_LUT)

    lum = torch.clamp(_fma(vy, 116.0, -16.0), max=100.0)
    a = torch.clamp(500.0 * (vx - vy), -120.0, 120.0)
    b = torch.clamp(200.0 * (vy - vz), -120.0, 120.0)
    return torch.stack([lum * _recip(100.0), a * _recip(120.0),
                        b * _recip(120.0)], dim=-1)


def color_distance(lab1: torch.Tensor, lab2: torch.Tensor) -> torch.Tensor:
    """Normalised Lab distance (color_conversion.cpp:86-96); broadcasts."""
    d = torch.abs(lab1 - lab2)
    dist = (d[..., 0] + (d[..., 1] + d[..., 2]) * 0.5) * _recip(3.0)
    return torch.clamp(dist, 0.0, 1.0)
