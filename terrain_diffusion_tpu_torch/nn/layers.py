"""Magnitude-preserving layers as ``nn.Module``s (NHWC activations).

Counterpart of ``terrain_diffusion_tpu.nn.layers``.  Parameter and buffer
names follow the reference state dict (``conv_res0.weight``, ``emb_gain``,
``attn_qkv.weight``, ...), conv weights are OIHW and linear weights
(out, in), so a reference checkpoint loads with ``load_state_dict``.

Forced weight normalization (EDM2): every forward normalizes the stored
weight globally, then scales it by gain / sqrt(fan_in).

Routing: a default-conv residual block whose output map has at least
128 x 128 pixels runs its conv body through the hand-written fused block
kernel (``ops/fused_block.py``), the JAX package's rule for its Pallas
kernel without the TPU batch cutover; smaller maps run the plain path.
A block built with ``attention_impl="pallas"`` (the JAX package's value
for its Pallas kernel, set through a model's ``block_kwargs``) runs its
attention core through the hand-written attention kernel
(``ops/attention.py``) wherever ``attention_eligible`` holds; any other value
runs the plain einsum.  The qkv and output 1x1 projections stay ``MPConv``.
The kernels define no backward (JAX: ``block_eligible`` is False for
``training``), so a training forward, and any forward through which
autograd records (``cuda_lib.autograd_live``: grad mode on and a parameter
or input requiring grad, or a ``torch.func.jvp`` in progress), runs the
plain path in every block, the in conv and the head.

Training (``unet_block_apply(training=, dropout_key=)`` in JAX): a block
built with ``dropout`` p > 0 drops the emb-modulated silu's output before
``conv_res1`` in a training forward, keeping each value with probability
1 - p and scaling kept values by 1 / (1 - p); the mask is drawn from a
generator seeded by the block's ``dropout_seed``.  ``normalize_weights_``
is the forced re-normalization after each optimizer update
(``norm_weights_tree``).
"""
from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from terrain_diffusion_tpu_torch.ops import mp
from terrain_diffusion_tpu_torch.ops.attention import (attention_eligible,
                                                       fused_pixelnorm_attention,
                                                       pixelnorm_attention_reference)
from terrain_diffusion_tpu_torch.ops.cuda_lib import autograd_live
from terrain_diffusion_tpu_torch.ops.fused_block import fused_block
from terrain_diffusion_tpu_torch.ops.nhwc import conv2d_nhwc, oihw_to_hwio

FUSED_MIN_PIXELS = 128 * 128


def _randn(shape, generator: torch.Generator, device) -> torch.Tensor:
    return torch.randn(shape, generator=generator).to(device)


class MPConv(nn.Module):
    """Magnitude-preserving conv (kernel () == linear layer)."""

    def __init__(self, in_channels: int, out_channels: int, kernel=(), *,
                 device, generator: torch.Generator):
        super().__init__()
        shape = (out_channels, in_channels, *kernel)
        self.weight = nn.Parameter(_randn(shape, generator, device))

    def prepared_weight(self, gain=1.0) -> torch.Tensor:
        """Normalized weight scaled by gain / sqrt(fan_in) (OIHW / (out, in))."""
        w = mp.normalize(self.weight)
        fan_in = int(np.prod(self.weight.shape[1:]))
        return w * (gain / math.sqrt(fan_in))

    def forward(self, x: torch.Tensor, gain=1.0) -> torch.Tensor:
        w = self.prepared_weight(gain).to(x.dtype)
        if w.dim() == 2:
            return torch.matmul(x, w.t())
        return conv2d_nhwc(x, w, padding=w.shape[-1] // 2)


class MPFourier(nn.Module):
    """cos(x*f + p) * sqrt(2) with random frequency/phase buffers."""

    def __init__(self, num_channels: int, s: float = 1.0, *, device,
                 generator: torch.Generator):
        super().__init__()
        freqs = 2 * np.pi * torch.randn((num_channels,), generator=generator) * s
        phases = 2 * np.pi * torch.rand((num_channels,), generator=generator)
        self.register_buffer("freqs", freqs.to(device))
        self.register_buffer("phases", phases.to(device))

    def forward(self, x):
        return mp.fourier_embedding(x, self.freqs, self.phases)


class MPPositional(nn.Module):
    """Deterministic [sin(x f), cos(x f)] * sqrt(2) embedding."""

    def __init__(self, num_channels: int, *, device):
        super().__init__()
        freqs = torch.from_numpy(mp.positional_embedding_freqs(num_channels))
        self.register_buffer("freqs", freqs.to(device))

    def forward(self, x):
        return mp.positional_embedding(x, self.freqs)


class MPEmbedding(nn.Module):
    def __init__(self, num_embeddings: int, dim: int, *, device,
                 generator: torch.Generator):
        super().__init__()
        self.weight = nn.Parameter(_randn((num_embeddings, dim), generator, device))

    def forward(self, idx):
        return mp.normalize(self.weight)[idx.long()]


def resample(x: torch.Tensor, mode: str = "keep", factor: int = 2) -> torch.Tensor:
    """NHWC resample: 'down' = strided decimation, 'up' = nearest replication."""
    if mode == "keep":
        return x
    if mode == "down":
        return x[:, ::factor, ::factor, :]
    if mode == "up":
        return x.repeat_interleave(factor, dim=1).repeat_interleave(factor, dim=2)
    raise ValueError(f"unknown resample mode {mode}")


def normalize_weights_(model: nn.Module) -> None:
    """Forced weight normalization after an optimizer update: every MP
    weight (each parameter of ndim >= 2: the conv, linear and embedding
    weights, JAX's ``path[-1] == "w"`` leaves) is set to ``mp.normalize(w)``;
    the scalar gains stay."""
    with torch.no_grad():
        for p in model.parameters():
            if p.dim() >= 2:
                p.copy_(mp.normalize(p))


class UNetBlock(nn.Module):
    """One magnitude-preserving U-Net block."""

    def __init__(self, in_channels: int, out_channels: int, emb_channels: int, *,
                 device, generator: torch.Generator, mode: str = "enc",
                 resample_mode: str = "keep", attention: bool = False,
                 channels_per_head: int = 64, res_balance: float = 0.3,
                 attn_balance: float = 0.3, clip_act=256.0,
                 conv_type: str = "default", resample_type: str = "pooling",
                 expansion_factor: int = 1, no_padding: bool = False,
                 activation: str = "silu", attention_impl: str = "xla",
                 dropout: float = 0.0, **_unused):
        super().__init__()
        if conv_type != "default" or expansion_factor != 1 or no_padding \
                or activation != "silu":
            raise NotImplementedError(
                "only conv_type='default', expansion_factor=1, SAME padding and "
                "silu blocks are ported")
        if resample_type == "conv" and resample_mode != "keep":
            raise NotImplementedError("learned conv resampling is not ported")
        self.mode = mode
        self.resample_mode = resample_mode
        self.res_balance = float(res_balance)
        self.attn_balance = float(attn_balance)
        self.clip_act = clip_act
        self.attention_impl = attention_impl
        self.dropout = float(dropout)
        # attention disables when out_channels < channels_per_head (no heads)
        self.num_heads = out_channels // channels_per_head if attention else 0
        kw = dict(device=device, generator=generator)
        self.emb_gain = nn.Parameter(torch.zeros((), device=device))
        self.conv_res0 = MPConv(out_channels if mode == "enc" else in_channels,
                                out_channels, (3, 3), **kw)
        self.emb_linear = (MPConv(emb_channels, out_channels, (), **kw)
                           if emb_channels > 0 else None)
        self.conv_res1 = MPConv(out_channels, out_channels, (3, 3), **kw)
        self.conv_skip = (MPConv(in_channels, out_channels, (1, 1), **kw)
                          if in_channels != out_channels else None)
        if self.num_heads > 0:
            self.attn_qkv = MPConv(out_channels, out_channels * 3, (1, 1), **kw)
            self.attn_proj = MPConv(out_channels, out_channels, (1, 1), **kw)

    def _emb_scale(self, emb):
        c = self.emb_linear(emb, gain=self.emb_gain) + 1.0
        return c / torch.sqrt(torch.mean(c * c, dim=-1, keepdim=True) + 1e-8)

    def _attention(self, x, kernels: bool = True):
        """Pixel-norm attention; qkv channels are laid out (head, channel,
        qkv) with qkv fastest.  ``kernels=False`` keeps the plain einsum."""
        y = self.attn_qkv(x)
        if kernels and self.attention_impl == "pallas" and not autograd_live(y) \
                and attention_eligible(y, self.num_heads):
            out = fused_pixelnorm_attention(y.contiguous(), self.num_heads)
        else:  # JAX's XLA formulation: normed q, k, v in the activations' type
            out = pixelnorm_attention_reference(y, self.num_heads, round_normed=True)
        return self.attn_proj(out.to(x.dtype))

    def _tail(self, x, kernels: bool = True):
        if self.num_heads > 0:
            x = mp.mp_sum([x, self._attention(x, kernels)], w=self.attn_balance)
            if self.clip_act is not None:
                x = torch.clamp(x, -self.clip_act, self.clip_act)
        return x

    def _fused(self, x, emb, x2, scales, pre_upsample):
        w0 = oihw_to_hwio(self.conv_res0.prepared_weight()).contiguous()
        w1 = oihw_to_hwio(self.conv_res1.prepared_weight()).contiguous()
        wskip = None
        if self.conv_skip is not None:
            ws = self.conv_skip.prepared_weight()  # (out, in, 1, 1)
            wskip = ws.reshape(ws.shape[0], ws.shape[1]).t().contiguous()
        c = None
        if self.emb_linear is not None and emb is not None:
            c = self._emb_scale(emb).float().contiguous()
        out = fused_block(
            x.contiguous(), w0, w1, c, wskip,
            x2.contiguous() if x2 is not None else None, mode=self.mode,
            pixel_norm=(self.mode == "enc"), res_balance=self.res_balance,
            clip_act=None if self.num_heads > 0 else self.clip_act,
            concat_scales=scales, pre_upsample=pre_upsample)
        return self._tail(out)

    def forward(self, x, emb, skip=None, concat_w: float = 0.3, training: bool = False,
                dropout_seed=None):
        """``training`` turns on dropout (with ``dropout_seed`` given) and,
        as any forward autograd records through, keeps the plain path."""
        h, w = x.shape[1], x.shape[2]
        f = {"up": 2.0, "down": 0.5}.get(self.resample_mode, 1.0)
        kernels = not training and not autograd_live(x, emb, skip, *self.parameters())
        fused = kernels and (h * f) * (w * f) >= FUSED_MIN_PIXELS
        # the parameter-free nearest-up runs inside the fused kernel
        defer_up = fused and self.resample_mode == "up" and skip is None
        if not defer_up:
            x = resample(x, self.resample_mode)
        if fused:
            x2 = scales = None
            if skip is not None and skip.shape == x.shape:
                scales = mp.concat_scales([x.shape[-1], skip.shape[-1]], concat_w)
                x2 = skip
            elif skip is not None:
                x = mp.mp_concat([x, skip], dim=-1, w=concat_w)
            return self._fused(x, emb, x2, scales, 2 if defer_up else 1)
        if skip is not None:
            x = mp.mp_concat([x, skip], dim=-1, w=concat_w)
        if self.mode == "enc":
            if self.conv_skip is not None:
                x = self.conv_skip(x)
            x = mp.normalize(x, dim=-1)  # pixel norm over channels
        y = self.conv_res0(mp.mp_silu(x))
        if self.emb_linear is not None and emb is not None:
            y = mp.mp_silu(y * self._emb_scale(emb)[:, None, None, :].to(y.dtype))
        else:
            y = mp.mp_silu(y)
        if training and self.dropout > 0 and dropout_seed is not None:
            mask_gen = torch.Generator(device=y.device).manual_seed(int(dropout_seed))
            keep = torch.rand(y.shape, generator=mask_gen, device=y.device) < 1.0 - self.dropout
            y = torch.where(keep, y / (1.0 - self.dropout), 0.0)
        y = self.conv_res1(y)
        if self.mode == "dec" and self.conv_skip is not None:
            x = self.conv_skip(x)
        x = mp.mp_sum([x, y], w=self.res_balance)
        if self.num_heads > 0:
            x = mp.mp_sum([x, self._attention(x, kernels)], w=self.attn_balance)
        if self.clip_act is not None:
            x = torch.clamp(x, -self.clip_act, self.clip_act)
        return x
