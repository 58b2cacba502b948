"""Image resampling primitives on torch tensors.

Counterpart of ``terrain_diffusion_tpu.ops.image``.  All functions operate
on tensors whose last two axes are (H, W); leading axes are batch/channel.

- ``resize_bilinear`` reproduces ``jax.image.resize(method='linear')``:
  triangle-kernel weights, widened by the scale factor when downsampling
  (antialiased), renormalized at the borders.  The weights are built as two
  dense (in, out) matrices and applied with two matmuls, so the result does
  not depend on any library's resize implementation.
- ``gaussian_blur``: odd kernel, reflect padding (torchvision semantics).
- ``grid_sample_bilinear``: ``F.grid_sample(bilinear, border,
  align_corners=False)`` written out, with or without a batch dim.
"""
from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F


@functools.lru_cache(maxsize=128)
def _resize_weights(in_size: int, out_size: int) -> np.ndarray:
    """(in_size, out_size) f32 linear-kernel weight matrix, as
    jax.image.scale_and_translate computes it (antialias=True)."""
    f32 = np.float32
    inv_scale = f32(1.0 / (out_size / in_size))  # f64 ratio, rounded once
    kernel_scale = max(inv_scale, f32(1.0))
    sample_f = (np.arange(out_size, dtype=f32) + f32(0.5)) * inv_scale - f32(0.5)
    x = np.abs(sample_f[None, :] - np.arange(in_size, dtype=f32)[:, None]) / kernel_scale
    weights = np.maximum(f32(0.0), f32(1.0) - x).astype(f32)
    total = np.sum(weights, axis=0, keepdims=True, dtype=f32)
    safe = np.where(total != 0, total, f32(1.0))
    weights = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                       weights / safe, f32(0.0))
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return np.where(inside[None, :], weights, f32(0.0)).astype(f32)


def resize_bilinear(x: torch.Tensor, size) -> torch.Tensor:
    """Resize the last two axes to `size` with (antialiased) bilinear filtering."""
    h, w = x.shape[-2:]
    oh, ow = int(size[0]), int(size[1])
    if ow != w:  # equal sizes are the identity, skipped as jax skips them
        wx = torch.from_numpy(_resize_weights(w, ow)).to(x.device, x.dtype)
        x = torch.matmul(x, wx)
    if oh != h:
        wy = torch.from_numpy(_resize_weights(h, oh)).to(x.device, x.dtype)
        x = torch.matmul(wy.transpose(0, 1), x)
    return x


def gaussian_kernel1d(kernel_size: int, sigma: float) -> np.ndarray:
    """torchvision _get_gaussian_kernel1d: pdf at linspace(-k/2, k/2, k), normalized."""
    half = (kernel_size - 1) * 0.5
    xs = np.linspace(-half, half, kernel_size)
    pdf = np.exp(-0.5 * (xs / sigma) ** 2)
    return (pdf / pdf.sum()).astype(np.float32)


def gaussian_blur(x: torch.Tensor, kernel_size: int, sigma: float) -> torch.Tensor:
    """Separable gaussian blur with reflect padding (torchvision semantics)."""
    k = torch.from_numpy(gaussian_kernel1d(kernel_size, sigma)).to(x.device, x.dtype)
    pad = kernel_size // 2
    lead = x.shape[:-2]
    h, w = x.shape[-2:]
    xf = F.pad(x.reshape(-1, 1, h, w), (pad, pad, pad, pad), mode="reflect")
    xf = F.conv2d(xf, k.reshape(1, 1, kernel_size, 1))
    xf = F.conv2d(xf, k.reshape(1, 1, 1, kernel_size))
    return xf.reshape(*lead, h, w)


def upsample_nearest(x: torch.Tensor, factor: int) -> torch.Tensor:
    """Nearest-neighbor integer upsampling of the last two axes."""
    return x.repeat_interleave(factor, dim=-2).repeat_interleave(factor, dim=-1)


def avg_pool(x: torch.Tensor, k: int) -> torch.Tensor:
    """Non-overlapping average pooling of the last two axes."""
    h, w = x.shape[-2:]
    return x.reshape(*x.shape[:-2], h // k, k, w // k, k).mean(dim=(-3, -1))


def max_pool(x: torch.Tensor, k: int) -> torch.Tensor:
    h, w = x.shape[-2:]
    return x.reshape(*x.shape[:-2], h // k, k, w // k, k).amax(dim=(-3, -1))


def min_pool(x: torch.Tensor, k: int) -> torch.Tensor:
    h, w = x.shape[-2:]
    return x.reshape(*x.shape[:-2], h // k, k, w // k, k).amin(dim=(-3, -1))


def avg_pool_stride1(x: torch.Tensor, win: int) -> torch.Tensor:
    """`F.avg_pool2d(x, win, stride=1, padding=0)` on the last two axes."""
    lead = x.shape[:-2]
    h, w = x.shape[-2:]
    out = F.avg_pool2d(x.reshape(-1, 1, h, w), win, stride=1)
    return out.reshape(*lead, h - win + 1, w - win + 1)


def grid_sample_bilinear(features: torch.Tensor, grid: torch.Tensor) -> torch.Tensor:
    """Bilinear sample of (..., C, H, W) features at (..., Hout, Wout, 2)
    grid positions (x, y in [-1, 1]), border padding, align_corners=False;
    returns (..., C, Hout, Wout).  Leading dims are a batch: each map is
    sampled at its own grid."""
    lead = features.shape[:-3]
    c, h, w = features.shape[-3:]
    flat = features.reshape(-1, c, h * w)
    n = flat.shape[0]
    grid = grid.reshape(n, *grid.shape[-3:])
    hout, wout = grid.shape[1:3]
    ix = ((grid[..., 0] + 1.0) * w - 1.0) * 0.5
    iy = ((grid[..., 1] + 1.0) * h - 1.0) * 0.5
    ix0 = torch.floor(ix)
    iy0 = torch.floor(iy)
    tx = (ix - ix0)[:, None]
    ty = (iy - iy0)[:, None]

    def gather(yi, xi):
        yi = torch.clamp(yi, 0, h - 1).long()
        xi = torch.clamp(xi, 0, w - 1).long()
        idx = (yi * w + xi).reshape(n, 1, hout * wout).expand(n, c, hout * wout)
        return flat.gather(2, idx).reshape(n, c, hout, wout)

    v00 = gather(iy0, ix0)
    v01 = gather(iy0, ix0 + 1)
    v10 = gather(iy0 + 1, ix0)
    v11 = gather(iy0 + 1, ix0 + 1)
    top = v00 * (1 - tx) + v01 * tx
    bot = v10 * (1 - tx) + v11 * tx
    return (top * (1 - ty) + bot * ty).reshape(*lead, c, hout, wout)


def signed_sqrt(x: torch.Tensor) -> torch.Tensor:
    """sign(x) * sqrt(|x|) - the Earth-dynamic-range transform."""
    return torch.sign(x) * torch.sqrt(torch.abs(x))


def signed_square(x: torch.Tensor) -> torch.Tensor:
    """sign(x) * x^2 - inverse of signed_sqrt."""
    return torch.sign(x) * x * x
