"""NARF keypoints and NARF-36 descriptors (port of
point_cloud_donkey_tpu/ops/narf.py; Steder et al., pcl::NarfKeypoint /
pcl::NarfDescriptor as wrapped at features/features_narf.cpp).

NARF reads a planar range image (a z-buffer on the host, camera at the
origin looking along +z: points with z <= 0 are skipped) and detects its
own keypoints: the surface-change score (a smoothed range gradient) away
from range jumps, 9 x 9 non-max suppression, the top 128.  The descriptor
is 36 beams of a star pattern on the range patch, each the weighted mean
range derivative along its ray (bilinear samples, holes renormalised),
squashed by atan to (-0.5, 0.5) and rolled so the strongest beam comes
first.  The top-k order, the suppression and the roll are decisions on
float scores: ties go to the lower index, as in the JAX package.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import numpy as np
import torch
import torch.nn.functional as F

NARF_LEN = 36
_BEAM_STEPS = 10


def build_range_image(xyz: np.ndarray, width: int = 640, height: int = 480,
                      focal: float = 525.0) -> Tuple[np.ndarray, float]:
    """(range [H, W] float32 with +inf holes, 1.0): the JAX
    ``build_range_image`` z-buffer."""
    rng_img = np.full((height, width), np.inf, np.float32)
    z = xyz[:, 2]
    ok = z > 1e-6
    u = np.round(focal * xyz[ok, 0] / z[ok] + width / 2.0).astype(np.int64)
    v = np.round(focal * xyz[ok, 1] / z[ok] + height / 2.0).astype(np.int64)
    r = np.linalg.norm(xyz[ok], axis=1).astype(np.float32)
    inside = (u >= 0) & (u < width) & (v >= 0) & (v < height)
    np.minimum.at(rng_img, (v[inside], u[inside]), r[inside])
    return rng_img, 1.0


class NarfKeypoints(NamedTuple):
    uv: torch.Tensor      # [K, 2] (row, col)
    xyz: torch.Tensor     # [K, 3] back-projected positions
    score: torch.Tensor   # [K]
    valid: torch.Tensor   # [K]


def narf_keypoints(range_img: torch.Tensor,   # [H, W], +inf holes
                   support_size: float, focal: float = 525.0,
                   max_keypoints: int = 128, border_jump: float = 0.15,
                   min_score: float = 0.02) -> NarfKeypoints:
    """The JAX ``narf_keypoints``: interest = the 3 x 3-smoothed range
    gradient where no 4-neighbour jumps by border_jump relative, local
    maxima over 9 x 9 windows above min_score, the top max_keypoints
    (stable: ties to the lower index), back-projected."""
    h, w = range_img.shape
    dt = range_img.dtype
    fin = torch.isfinite(range_img)
    r = torch.where(fin, range_img, torch.zeros_like(range_img))
    inf = torch.full_like(range_img, math.inf)

    def shift(img, dy, dx, fill):
        return torch.roll(torch.where(fin, img, fill), (dy, dx), (0, 1))

    jumps = []
    for dy, dx in ((0, 1), (0, -1), (1, 0), (-1, 0)):
        nb = shift(range_img, dy, dx, inf)
        nb_fin = torch.roll(fin, (dy, dx), (0, 1))
        rel = torch.abs(nb - range_img) / torch.clamp(range_img, min=1e-6)
        jumps.append(torch.where(nb_fin & fin, rel, torch.ones_like(rel)))
    border = torch.maximum(torch.maximum(jumps[0], jumps[1]),
                           torch.maximum(jumps[2], jumps[3]))
    zero = torch.zeros_like(r)
    gx = (shift(r, 0, -1, zero) - shift(r, 0, 1, zero)) * 0.5
    gy = (shift(r, -1, 0, zero) - shift(r, 1, 0, zero)) * 0.5
    change = torch.sqrt(gx * gx + gy * gy)
    kernel = torch.full((1, 1, 3, 3), 1.0 / 9.0, dtype=dt,
                        device=range_img.device)
    change = F.conv2d(change[None, None], kernel, padding=1)[0, 0]
    score = torch.where(fin & (border < border_jump), change, zero)
    pooled = F.max_pool2d(score[None, None], 9, stride=1, padding=4)[0, 0]
    is_max = (score >= pooled) & (score > min_score)
    flat = torch.where(is_max, score, zero).reshape(-1)
    top_scores, top_idx = torch.sort(flat, descending=True, stable=True)
    top_scores, top_idx = top_scores[:max_keypoints], top_idx[:max_keypoints]
    vv = torch.div(top_idx, w, rounding_mode="floor").to(dt)
    uu = (top_idx % w).to(dt)
    valid = top_scores > 0
    rr = range_img.reshape(-1)[top_idx]
    x = (uu - w / 2.0) / focal
    y = (vv - h / 2.0) / focal
    dir_vec = torch.stack([x, y, torch.ones_like(x)], 1)
    dir_vec = dir_vec / torch.linalg.norm(dir_vec, dim=1, keepdim=True)
    xyz = dir_vec * torch.where(valid, rr, torch.zeros_like(rr))[:, None]
    return NarfKeypoints(uv=torch.stack([vv, uu], 1), xyz=xyz,
                         score=top_scores, valid=valid)


def _bilinear(img, fin, vv, uu):
    """Bilinear samples with holes: invalid taps drop out and the weights
    renormalise; (value, enough weight)."""
    h, w = img.shape
    v0 = torch.clamp(torch.floor(vv).to(torch.int64), 0, h - 2)
    u0 = torch.clamp(torch.floor(uu).to(torch.int64), 0, w - 2)
    fv = vv - v0
    fu = uu - u0
    acc = torch.zeros_like(vv)
    wacc = torch.zeros_like(vv)
    for dv in (0, 1):
        for du in (0, 1):
            wt = (fv if dv else 1 - fv) * (fu if du else 1 - fu)
            val = img[v0 + dv, u0 + du]
            ok = fin[v0 + dv, u0 + du]
            acc = acc + torch.where(ok, wt * val, torch.zeros_like(wt))
            wacc = wacc + torch.where(ok, wt, torch.zeros_like(wt))
    return acc / torch.clamp(wacc, min=1e-6), wacc > 1e-3


def narf_descriptor(range_img: torch.Tensor, kp: NarfKeypoints,
                    support_size: float, focal: float = 525.0,
                    rotation_invariant: bool = True
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """([K, 36] descriptors, [K] valid): the JAX ``narf_descriptor``."""
    fin = torch.isfinite(range_img)
    img = torch.where(fin, range_img, torch.zeros_like(range_img))
    dt = img.dtype
    dev = img.device
    rr = torch.clamp(torch.linalg.norm(kp.xyz, dim=1), min=1e-3)
    pix_radius = focal * (support_size * 0.5) / rr
    angles = torch.arange(NARF_LEN, dtype=dt, device=dev) \
        * (2.0 * math.pi / NARF_LEN)
    steps = (torch.arange(_BEAM_STEPS, dtype=dt, device=dev) + 1.0) \
        / _BEAM_STEPS
    dv = torch.sin(angles)[None, :, None] * steps[None, None, :] \
        * pix_radius[:, None, None]
    du = torch.cos(angles)[None, :, None] * steps[None, None, :] \
        * pix_radius[:, None, None]
    vv = kp.uv[:, 0][:, None, None] + dv
    uu = kp.uv[:, 1][:, None, None] + du
    samples, ok = _bilinear(img, fin, vv, uu)
    center = _bilinear(img, fin, kp.uv[:, 0][:, None, None],
                       kp.uv[:, 1][:, None, None])[0]
    prev = torch.cat([center.expand(samples[..., :1].shape),
                      samples[..., :-1]], -1)
    deriv = samples - prev
    wt = (1.0 - steps)[None, None, :] * ok.to(dt)
    beam = (deriv * wt).sum(-1) / torch.clamp(wt.sum(-1), min=1e-6)
    desc = torch.arctan(beam / max(support_size / NARF_LEN, 1e-6)) / math.pi
    if rotation_invariant:
        dom = torch.argmax(desc.abs(), dim=1)
        idx = (dom[:, None] + torch.arange(NARF_LEN, device=dev)[None, :]) \
            % NARF_LEN
        desc = torch.gather(desc, 1, idx)
    valid = kp.valid & torch.isfinite(desc).all(1)
    return desc, valid
