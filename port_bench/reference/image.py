"""Image, Laplacian and climate operations of the world's stages and output
composition: frozen copies of the port's ``ops/image.py``,
``ops/laplacian.py``, ``ops/windows.py`` and
``pipeline/postprocessing.py::local_baseline_temperature``."""
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


def _same(x):
    return x


def resize_bilinear(x: torch.Tensor, size, q=_same) -> torch.Tensor:
    """Resize the last two axes to `size` with (antialiased) bilinear filtering."""
    h, w = x.shape[-2:]
    oh, ow = int(size[0]), int(size[1])
    if ow != w:  # equal sizes are the identity, skipped as jax skips them
        wx = torch.from_numpy(_resize_weights(w, ow)).to(x.device, x.dtype)
        x = torch.matmul(q(x), q(wx))
    if oh != h:
        wy = torch.from_numpy(_resize_weights(h, oh)).to(x.device, x.dtype)
        x = torch.matmul(q(wy.transpose(0, 1)), q(x))
    return x


def gaussian_kernel1d(kernel_size: int, sigma: float) -> np.ndarray:
    """torchvision _get_gaussian_kernel1d: pdf at linspace(-k/2, k/2, k), normalized."""
    half = (kernel_size - 1) * 0.5
    xs = np.linspace(-half, half, kernel_size)
    pdf = np.exp(-0.5 * (xs / sigma) ** 2)
    return (pdf / pdf.sum()).astype(np.float32)


def gaussian_blur(x: torch.Tensor, kernel_size: int, sigma: float, q=_same) -> torch.Tensor:
    """Separable gaussian blur with reflect padding (torchvision semantics)."""
    k = torch.from_numpy(gaussian_kernel1d(kernel_size, sigma)).to(x.device, x.dtype)
    pad = kernel_size // 2
    lead = x.shape[:-2]
    h, w = x.shape[-2:]
    xf = F.pad(x.reshape(-1, 1, h, w), (pad, pad, pad, pad), mode="reflect")
    xf = F.conv2d(q(xf), q(k.reshape(1, 1, kernel_size, 1)))
    xf = F.conv2d(q(xf), q(k.reshape(1, 1, 1, kernel_size)))
    return xf.reshape(*lead, h, w)


def upsample_nearest(x: torch.Tensor, factor: int) -> torch.Tensor:
    """Nearest-neighbor integer upsampling of the last two axes."""
    return x.repeat_interleave(factor, dim=-2).repeat_interleave(factor, dim=-1)


def avg_pool_stride1(x: torch.Tensor, win: int, q=_same) -> torch.Tensor:
    """`F.avg_pool2d(x, win, stride=1, padding=0)` on the last two axes (a
    convolution with a box kernel: ``q`` rounds its operand)."""
    lead = x.shape[:-2]
    h, w = x.shape[-2:]
    out = F.avg_pool2d(q(x.reshape(-1, 1, h, w)), win, stride=1)
    return out.reshape(*lead, h - win + 1, w - win + 1)


def grid_sample_bilinear(features: torch.Tensor, grid: torch.Tensor, q=_same) -> torch.Tensor:
    """Bilinear sample of (..., C, H, W) features at (..., Hout, Wout, 2)
    grid positions (x, y in [-1, 1]), border padding, align_corners=False;
    returns (..., C, Hout, Wout).  Leading dims are a batch: each map is
    sampled at its own grid.  ``q`` rounds both operands of the weighted
    sums (the features and the weights)."""
    features = q(features)
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
    tx = q((ix - ix0)[:, None])
    ty = q((iy - iy0)[:, None])

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


def signed_square(x: torch.Tensor) -> torch.Tensor:
    """sign(x) * x^2 - inverse of signed_sqrt."""
    return torch.sign(x) * x * x


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


def resize_extrapolated(x: torch.Tensor, size, q=_same) -> torch.Tensor:
    """Bilinear resize that linearly extrapolates beyond the borders."""
    target_h, target_w = int(size[0]), int(size[1])
    h, w = x.shape[-2:]
    scale_h = target_h / h
    scale_w = target_w / w
    out = resize_bilinear(pad_linear_extrapolation(x), q=q, size=
                          (int(round(target_h + 2 * scale_h)),
                           int(round(target_w + 2 * scale_w))))
    pad_h = int(round(scale_h))
    pad_w = int(round(scale_w))
    return out[..., pad_h:pad_h + target_h, pad_w:pad_w + target_w]


def _blur_kernel_size(sigma: float) -> int:
    return int(sigma * 2) // 2 * 2 + 1


def laplacian_decode(residual: torch.Tensor, lowres: torch.Tensor,
                     extrapolate: bool = False, q=_same) -> torch.Tensor:
    """residual + upsample(lowres)."""
    size = tuple(residual.shape[-2:])
    return residual + (resize_extrapolated(lowres, size, q) if extrapolate
                       else resize_bilinear(lowres, size, q))


def laplacian_denoise(residual: torch.Tensor, lowres: torch.Tensor, sigma: float, q=_same):
    """Re-estimate the low band from the decoded signal (seam denoising)."""
    decoded = laplacian_decode(residual, lowres, extrapolate=True, q=q)
    new_lowres = resize_bilinear(decoded, (lowres.shape[-2], lowres.shape[-1]), q)
    new_lowres = gaussian_blur(new_lowres, _blur_kernel_size(sigma), sigma, q)
    return residual, new_lowres


def local_baseline_temperature(T: torch.Tensor, e: torch.Tensor, win: int = 3,
                               beta_clip=(-0.012, 0.0), fallback_beta: float = -0.0065,
                               eps: float = 1e-6, fallback_threshold: float = 0.3, q=_same):
    """Windowed land-masked regression of temperature on elevation.

    T, e: (..., H, W) temperature [C] and elevation [m], leading dims a
    batch; win: odd window (valid pooling, output cropped by win-1).
    Returns (T_sea, beta), each (..., H-(win-1), W-(win-1)): sea-level
    baseline and local lapse rate.  ``q`` rounds the operands of the
    window sums.
    """
    w = (e > 0).to(T.dtype)

    def wavg(x):
        num = avg_pool_stride1(x * w, win, q)
        den = avg_pool_stride1(w, win, q)
        return num / (den + eps), den

    mu_T, sum_w = wavg(T)
    mu_e, _ = wavg(e)
    mu_e2, _ = wavg(e * e)
    mu_eT, _ = wavg(e * T)
    var_e = mu_e2 - mu_e * mu_e
    cov_eT = mu_eT - mu_e * mu_T
    beta = cov_eT / (var_e + eps)
    invalid = (var_e < 1.0) | (sum_w < fallback_threshold)
    beta = torch.where(invalid, torch.full_like(beta, fallback_beta), beta)
    beta = torch.clamp(beta, beta_clip[0], beta_clip[1])
    pad = (win - 1) // 2
    h, w_ = T.shape[-2:]
    T_c = T[..., pad:h - pad, pad:w_ - pad]
    e_c = e[..., pad:h - pad, pad:w_ - pad]
    return T_c - beta * e_c, beta


def linear_weight_window(size: int, eps: float = 1e-3, dtype=np.float32) -> np.ndarray:
    """(size, size) separable linear window: 1 at center, eps at edges."""
    mid = (size - 1) / 2
    r = np.arange(size, dtype=np.float64)
    w1 = 1 - (1 - eps) * np.clip(np.abs(r - mid) / mid, 0, 1)
    return (w1[:, None] * w1[None, :]).astype(dtype)
