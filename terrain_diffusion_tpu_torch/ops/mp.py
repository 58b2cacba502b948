"""Magnitude-preserving primitives (EDM2 style) on torch tensors.

Counterpart of ``terrain_diffusion_tpu.ops.mp``: forced weight
normalization, MP activations, MP sum/concat and the noise-label
embeddings.  Channel-dim conventions are explicit arguments; the U-Net
keeps activations NHWC, as the JAX package does.
"""
from __future__ import annotations

import math

import numpy as np
import torch


def normalize(x: torch.Tensor, dim=None, eps: float = 1e-4) -> torch.Tensor:
    """x / (eps + ||x||_dim * sqrt(numel(norm)/numel(x))) - RMS-style norm.

    dim=None normalizes globally (forced weight normalization)."""
    x32 = x.float()
    if dim is None:
        norm = torch.sqrt(torch.sum(x32 * x32))
        norm_numel = 1
    else:
        dims = (dim,) if isinstance(dim, int) else tuple(dim)
        norm = torch.sqrt(torch.sum(x32 * x32, dim=dims, keepdim=True))
        n = x.numel()
        for d in dims:
            n //= x.shape[d]
        norm_numel = n
    denom = eps + norm * float(np.sqrt(norm_numel / x.numel()))
    return (x32 / denom).to(x.dtype)


def _const(v: float, x: torch.Tensor) -> float:
    """Python constant `v` as the JAX package applies it to `x`: a weakly
    typed scalar takes x's type, so against a 16-bit x it is rounded to that
    type first (0.7 is 0.69921875 in bf16).  PyTorch would apply it in
    float32."""
    if x.dtype in (torch.bfloat16, torch.float16):
        return float(torch.tensor(v, dtype=x.dtype))
    return float(v)


def _div(x: torch.Tensor, v: float) -> torch.Tensor:
    """x / v as XLA computes it: against a 16-bit x, a product with the
    float32 reciprocal of v in x's type."""
    if x.dtype in (torch.bfloat16, torch.float16):
        return x * (1.0 / _const(v, x))
    return x / v


def mp_silu(x: torch.Tensor) -> torch.Tensor:
    if x.dtype in (torch.bfloat16, torch.float16):
        # the JAX package's 16-bit sigmoid is 1 / (1 + exp(-x)), rounded to
        # the type at each op; the float32 form rounds once
        return _div(x * torch.sigmoid(x), 0.596)
    return (x * torch.sigmoid(x)) / 0.596


def mp_leaky_relu(x: torch.Tensor, alpha: float) -> torch.Tensor:
    factor = math.sqrt((1 + alpha ** 2) / 2)
    return _div(torch.where(x >= 0, x, _const(alpha, x) * x), factor)


def _resolve_weights(n: int, w) -> np.ndarray:
    if w is None:
        return np.full((n,), 1.0 / n, dtype=np.float64)
    if isinstance(w, float):
        return np.array([1.0 - w, w], dtype=np.float64)
    return np.asarray(w, dtype=np.float64)


def mp_sum(args, w=None) -> torch.Tensor:
    """Magnitude-preserving weighted sum: sum(a_i * w_i) / ||w||_2."""
    wv = _resolve_weights(len(args), w)
    norm = float(np.linalg.norm(wv))
    out = args[0] * _const(wv[0], args[0])
    for a, wi in zip(args[1:], wv[1:]):
        out = out + a * _const(wi, a)
    return _div(out, norm)


def concat_scales(n_ch, w=None) -> list:
    """Per-input scales of mp_concat for inputs with `n_ch` channels."""
    wv = _resolve_weights(len(n_ch), w)
    c = math.sqrt(sum(n_ch) / float(np.sum(wv ** 2)))
    return [float(c / math.sqrt(n) * wv[i]) for i, n in enumerate(n_ch)]


def mp_concat(args, dim: int = -1, w=None) -> torch.Tensor:
    """Magnitude-preserving concat: each arg scaled so its contribution in
    subsequent layers is proportional to w_i regardless of channel count."""
    scales = concat_scales([a.shape[dim] for a in args], w)
    return torch.cat([a * _const(s, a) for a, s in zip(args, scales)], dim=dim)


def positional_embedding_freqs(num_channels: int) -> np.ndarray:
    """MPPositionalEmbedding frequency table."""
    half = num_channels // 2
    emb = math.log(10) / (half - 1)
    return np.exp(np.arange(half) * -emb).astype(np.float32)


def positional_embedding(x: torch.Tensor, freqs: torch.Tensor) -> torch.Tensor:
    """Deterministic MP positional embedding: [sin(x f), cos(x f)] * sqrt(2)."""
    y = x.float()[..., None] * freqs[None, :].float()
    y = torch.cat([torch.sin(y), torch.cos(y)], dim=-1) * math.sqrt(2.0)
    return y.to(x.dtype)


def fourier_embedding(x: torch.Tensor, freqs: torch.Tensor,
                      phases: torch.Tensor) -> torch.Tensor:
    """MPFourier: cos(x*f + p) * sqrt(2) with random freqs/phases buffers."""
    y = x.float()[..., None] * freqs[None, :].float()
    y = y + phases[None, :].float()
    return (torch.cos(y) * math.sqrt(2.0)).to(x.dtype)
