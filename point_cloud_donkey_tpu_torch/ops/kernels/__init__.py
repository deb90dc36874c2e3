"""Wrappers of the port's CUDA kernels, one module per Pallas module of the
JAX package (lrf_moments, shot_fused, chisq, shot_hist, histogram).

Every wrapper checks device, dtype, shape and contiguity, then dispatches
on the device of its input: CPU tensors run the plain PyTorch twin that
lives beside the kernel, CUDA tensors launch the kernel (built at first
use, kernels/build.py) or raise.  Nothing falls back from one to the
other."""

from __future__ import annotations

from typing import Optional, Sequence

import torch


def uses_kernel(*tensors: torch.Tensor) -> bool:
    """True for CUDA inputs (launch the kernel), False for CPU inputs (run
    the plain twin); mixed or other devices raise."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"inputs live on several devices: {sorted(map(str, devices))}")
    dev = devices.pop()
    if dev.type == "cuda":
        return True
    if dev.type == "cpu":
        return False
    raise ValueError(f"unsupported device {dev}: expected cpu or cuda")


def check(name: str, t: torch.Tensor, dtype: torch.dtype,
          shape: Sequence[Optional[int]]) -> None:
    """Raise unless t has the dtype, the shape (None = any extent) and a
    contiguous layout that the kernel indexes."""
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if t.dim() != len(shape) or any(
            s is not None and s != n for s, n in zip(shape, t.shape)):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")


def stream_of(t: torch.Tensor) -> int:
    """Handle of PyTorch's current stream on t's device."""
    return torch.cuda.current_stream(t.device).cuda_stream


def f32(x: float) -> float:
    """x rounded to float32, as the kernels receive it."""
    return float(torch.tensor(x, dtype=torch.float32))


def masked_centroid(points: torch.Tensor,   # [B, N, 3]
                    mask: torch.Tensor      # [B, N]
                    ) -> torch.Tensor:
    """Each cloud's centroid [B, 3] over its unmasked points, with the same
    bits whatever the batch around the cloud, so detect() equals its row
    of detect_batch().  The CPU's sum reduces each cloud in one order; a
    CUDA sum splits the reduction by the batch's size, so on the card the
    sum is the last row of a float64 cumulative sum along the points (one
    thread a column, in point order), rounded to float32.  The count is
    exact."""
    m = mask.to(points.dtype)
    count = torch.clamp(m.sum(1), min=1.0)[:, None]
    if points.device.type != "cuda":
        return (points * m[..., None]).sum(1) / count
    total = torch.cumsum((points * m[..., None]).double(), dim=1)[:, -1]
    return total.float() / count
