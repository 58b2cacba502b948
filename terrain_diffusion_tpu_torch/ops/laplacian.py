"""Laplacian pyramid codec on torch tensors.

Counterpart of ``terrain_diffusion_tpu.ops.laplacian``: elevation (after
signed-sqrt) splits into a blurred low-resolution band and a full-resolution
residual; decoding re-upsamples the low band and adds the residual.
``laplacian_denoise`` re-estimates the low band from the decoded output to
remove cross-tile seam noise before the final decode.
"""
from __future__ import annotations

import torch

from terrain_diffusion_tpu_torch.ops.image import gaussian_blur, resize_bilinear


def pad_linear_extrapolation(x: torch.Tensor) -> torch.Tensor:
    """Pad H and W by 1 with linear extrapolation (2*edge - next)."""
    h, w = x.shape[-2:]
    if h > 1:
        top = 2 * x[..., 0:1, :] - x[..., 1:2, :]
        bot = 2 * x[..., -1:, :] - x[..., -2:-1, :]
    else:
        top, bot = x[..., 0:1, :], x[..., -1:, :]
    x = torch.cat([top, x, bot], dim=-2)
    if w > 1:
        left = 2 * x[..., :, 0:1] - x[..., :, 1:2]
        right = 2 * x[..., :, -1:] - x[..., :, -2:-1]
    else:
        left, right = x[..., :, 0:1], x[..., :, -1:]
    return torch.cat([left, x, right], dim=-1)


def resize_extrapolated(x: torch.Tensor, size) -> torch.Tensor:
    """Bilinear resize that linearly extrapolates beyond the borders."""
    target_h, target_w = int(size[0]), int(size[1])
    h, w = x.shape[-2:]
    scale_h = target_h / h
    scale_w = target_w / w
    out = resize_bilinear(pad_linear_extrapolation(x),
                          (int(round(target_h + 2 * scale_h)),
                           int(round(target_w + 2 * scale_w))))
    pad_h = int(round(scale_h))
    pad_w = int(round(scale_w))
    return out[..., pad_h:pad_h + target_h, pad_w:pad_w + target_w]


def _blur_kernel_size(sigma: float) -> int:
    return int(sigma * 2) // 2 * 2 + 1


def laplacian_encode(x: torch.Tensor, downsample_size, sigma: float,
                     extrapolate: bool = False):
    """Split x into (residual, lowres)."""
    if isinstance(downsample_size, int):
        # torchvision TF.resize(int): the smaller edge becomes downsample_size
        h, w = x.shape[-2:]
        if h <= w:
            downsample_size = (downsample_size,
                               max(int(round(downsample_size * w / h)), 1))
        else:
            downsample_size = (max(int(round(downsample_size * h / w)), 1),
                               downsample_size)
    lowres = resize_bilinear(x, downsample_size)
    lowres = gaussian_blur(lowres, _blur_kernel_size(sigma), sigma)
    if extrapolate:
        lowres_up = resize_extrapolated(lowres, x.shape[-2:])
    else:
        lowres_up = resize_bilinear(lowres, x.shape[-2:])
    return x - lowres_up, lowres


def laplacian_decode(residual: torch.Tensor, lowres: torch.Tensor,
                     extrapolate: bool = False) -> torch.Tensor:
    """residual + upsample(lowres)."""
    size = residual.shape[-2:]
    if extrapolate:
        return residual + resize_extrapolated(lowres, size)
    return residual + resize_bilinear(lowres, size)


def laplacian_denoise(residual: torch.Tensor, lowres: torch.Tensor, sigma: float):
    """Re-estimate the low band from the decoded signal (seam denoising)."""
    decoded = laplacian_decode(residual, lowres, extrapolate=True)
    new_lowres = resize_bilinear(decoded, (lowres.shape[-2], lowres.shape[-1]))
    new_lowres = gaussian_blur(new_lowres, _blur_kernel_size(sigma), sigma)
    return residual, new_lowres
