"""Magnitude-preserving layers as ``nn.Module``s (NHWC activations).

Counterpart of ``terrain_diffusion_tpu.nn.layers``.  Parameter and buffer
names follow the reference state dict (``conv_res0.weight``, ``emb_gain``,
``attn_qkv.weight``, ...), conv weights are OIHW and linear weights
(out, in), so a reference checkpoint loads with ``load_state_dict``.

Forced weight normalization (EDM2): every forward normalizes the stored
weight globally, then scales it by gain / sqrt(fan_in).

Block options (JAX ``unet_block_init`` / ``unet_block_apply``):
``conv_type`` "default" (3x3 then 3x3), "fused" (3x3 then 1x1) or "mobile"
(a 1x1 ``conv_res0.0`` and a depthwise 3x3 ``conv_res0.1``, then 1x1),
``expansion_factor`` (the middle width is out_channels times it),
``no_padding`` (VALID convs, the residual cropped to the conv output),
``activation`` "silu" or "leaky_relu" (slope 0.2, magnitude-preserving),
and ``resample_type="conv"`` (``MPConvResample``: a learned stride-k conv or
transposed conv blended with the parameter-free resample by
``resample_skip_weight``, k = ``resample_filter``).

Routing: a default-conv residual block (3x3 convs, expansion 1, SAME
padding, silu; JAX's ``block_eligible``) whose output map has at least
128 x 128 pixels runs its conv body through the hand-written fused block
kernel (``ops/fused_block.py``), the JAX package's rule for its Pallas
kernel without the TPU batch cutover; smaller maps and every other block
run the plain path, on every device.
``block_kernels`` (an attribute of each block and each ``EDMUnet2D``, True
by default) is the model's switch for the block and 3x3-conv kernels:
``with_block_impl(model, "xla")`` gives the model with it off (JAX's
``block_impl="xla"``), so every block and in / out conv runs the plain
path, while attention keeps following ``attention_impl``.
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
(``norm_weights_tree``).  In data-parallel training ``rows``
(``parallel.mesh.Rows``) says which rows of the global batch the forward
holds: the mask is drawn at the global batch's shape and cut to them, so
the ranks together drop what one process would.
"""
from __future__ import annotations

import copy
import itertools
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
from terrain_diffusion_tpu_torch.ops.nhwc import (conv2d_nhwc, conv_transpose2d_nhwc, matmul_16,
                                                 oihw_to_hwio)

FUSED_MIN_PIXELS = 128 * 128
BLOCK_IMPLS = ("pallas", "xla")  # JAX's block_impl values: kernels, plain path


def _randn(shape, generator: torch.Generator, device) -> torch.Tensor:
    return torch.randn(shape, generator=generator).to(device)


class MPConv(nn.Module):
    """Magnitude-preserving conv (kernel () == linear layer); ``groups``
    and ``no_padding`` (VALID instead of SAME) as in JAX's
    ``mp_conv_apply``."""

    def __init__(self, in_channels: int, out_channels: int, kernel=(), *,
                 device, generator: torch.Generator, groups: int = 1,
                 no_padding: bool = False):
        super().__init__()
        self.groups = groups
        self.no_padding = no_padding
        shape = (out_channels, in_channels // groups, *kernel)
        self.weight = nn.Parameter(_randn(shape, generator, device))

    def prepared_weight(self, gain=1.0) -> torch.Tensor:
        """Normalized weight scaled by gain / sqrt(fan_in) (OIHW / (out, in))."""
        w = mp.normalize(self.weight)
        fan_in = int(np.prod(self.weight.shape[1:]))
        return w * (gain / math.sqrt(fan_in))

    def forward(self, x: torch.Tensor, gain=1.0) -> torch.Tensor:
        w = self.prepared_weight(gain).to(x.dtype)
        if w.dim() == 2:
            return matmul_16(x, w.t())
        return conv2d_nhwc(x, w, padding=0 if self.no_padding else w.shape[-1] // 2,
                           groups=self.groups)


class MPConvResample(nn.Module):
    """Learned resampling (JAX ``mp_conv_resample_init`` / ``_apply``): a
    k x k conv of stride k ("down", weight (out, in, k, k)) or a transposed
    conv of stride k ("up", weight (in, out, k, k)), mp_sum'd with the
    parameter-free resample by factor k.  The weight starts at ones, as in
    JAX.  JAX's ``conv_transpose`` does not flip its kernel, so the "up"
    weight runs flipped through ``conv_transpose2d``."""

    def __init__(self, resample_mode: str, kernel: int, in_channels: int,
                 out_channels: int, *, device):
        super().__init__()
        if resample_mode not in ("up", "down"):
            raise ValueError("resample_mode must be 'up' or 'down'")
        self.resample_mode = resample_mode
        shape = ((out_channels, in_channels) if resample_mode == "down"
                 else (in_channels, out_channels)) + (kernel, kernel)
        self.weight = nn.Parameter(torch.ones(shape, device=device))

    def forward(self, x: torch.Tensor, skip_weight: float) -> torch.Tensor:
        k = self.weight.shape[-1]
        c_in = self.weight.shape[1 if self.resample_mode == "down" else 0]
        w = mp.normalize(self.weight) * (1.0 / math.sqrt(k * k * c_in))
        w = w.to(x.dtype)
        if self.resample_mode == "down":
            y = conv2d_nhwc(x, w, stride=k)
        else:
            y = conv_transpose2d_nhwc(x, w.flip(-2, -1), stride=k)
        return mp.mp_sum([y, resample(x, self.resample_mode, factor=k)], w=float(skip_weight))


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


_ACTIVATIONS = {
    "silu": mp.mp_silu,
    "leaky_relu": lambda x: mp.mp_leaky_relu(x, 0.2),
}


def normalize_weights_(model: nn.Module) -> None:
    """Forced weight normalization after an optimizer update: every MP
    weight (each parameter of ndim >= 2: the conv, linear and embedding
    weights, JAX's ``path[-1] == "w"`` leaves) is set to ``mp.normalize(w)``;
    the scalar gains stay."""
    with torch.no_grad():
        for p in model.parameters():
            if p.dim() >= 2:
                p.copy_(mp.normalize(p))


def shared_copy(model: nn.Module) -> nn.Module:
    """A copy of ``model``'s modules that shares its parameters and buffers
    (JAX: a new model object over the same parameter tree)."""
    memo = {id(t): t for t in itertools.chain(model.parameters(), model.buffers())}
    return copy.deepcopy(model, memo)


def with_block_impl(model: nn.Module, block_impl: str) -> nn.Module:
    """``model`` with its block and 3x3-conv kernels on ("pallas") or off
    ("xla"): the model itself where every switch already says so, else a
    ``shared_copy`` with the switches set, so that two users of one model
    can differ."""
    if block_impl not in BLOCK_IMPLS:
        raise ValueError(f"block_impl must be one of {BLOCK_IMPLS}, got {block_impl!r}")
    on = block_impl == "pallas"
    switched = [m for m in model.modules() if hasattr(m, "block_kernels")]
    if all(m.block_kernels == on for m in switched):
        return model
    model = shared_copy(model)
    for m in model.modules():
        if hasattr(m, "block_kernels"):
            m.block_kernels = on
    return model


class UNetBlock(nn.Module):
    """One magnitude-preserving U-Net block."""

    block_kernels = True  # the fused-block kernel where eligible (with_block_impl)

    def __init__(self, in_channels: int, out_channels: int, emb_channels: int, *,
                 device, generator: torch.Generator, mode: str = "enc",
                 resample_mode: str = "keep", attention: bool = False,
                 channels_per_head: int = 64, res_balance: float = 0.3,
                 attn_balance: float = 0.3, clip_act=256.0,
                 conv_type: str = "default", resample_type: str = "pooling",
                 resample_filter: int = 4, resample_skip_weight: float = 0.5,
                 expansion_factor: int = 1, no_padding: bool = False,
                 activation: str = "silu", attention_impl: str = "xla",
                 dropout: float = 0.0, **_unused):
        super().__init__()
        if conv_type not in ("default", "fused", "mobile"):
            raise ValueError(f"unknown conv_type {conv_type!r}")
        if activation not in _ACTIVATIONS:
            raise ValueError(f"unknown activation {activation!r}")
        self.mode = mode
        self.resample_mode = resample_mode
        self.res_balance = float(res_balance)
        self.attn_balance = float(attn_balance)
        self.clip_act = clip_act
        self.attention_impl = attention_impl
        self.dropout = float(dropout)
        self.conv_type = conv_type
        self.no_padding = bool(no_padding)
        self.act = _ACTIVATIONS[activation]
        self.resample_skip_weight = float(resample_skip_weight)
        # JAX's block_eligible: the kernel covers only the default block
        self.kernel_block = (conv_type == "default" and expansion_factor == 1
                             and not no_padding and activation == "silu")
        # attention disables when out_channels < channels_per_head (no heads)
        self.num_heads = out_channels // channels_per_head if attention else 0
        kw = dict(device=device, generator=generator)
        self.emb_gain = nn.Parameter(torch.zeros((), device=device))
        self.resample = (MPConvResample(resample_mode, resample_filter, in_channels,
                                        out_channels, device=device)
                         if resample_type == "conv" and resample_mode != "keep" else None)
        c0 = out_channels if mode == "enc" else in_channels
        mid = out_channels * expansion_factor
        valid = dict(kw, no_padding=self.no_padding)
        if conv_type == "mobile":  # 1x1, then depthwise 3x3
            self.conv_res0 = nn.Sequential(MPConv(c0, mid, (1, 1), **kw),
                                           MPConv(mid, mid, (3, 3), groups=mid, **valid))
        else:
            self.conv_res0 = MPConv(c0, mid, (3, 3), **valid)
        self.emb_linear = (MPConv(emb_channels, mid, (), **kw)
                           if emb_channels > 0 else None)
        self.conv_res1 = MPConv(mid, out_channels,
                                (3, 3) if conv_type == "default" else (1, 1), **valid)
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
                dropout_seed=None, rows=None):
        """``training`` turns on dropout (with ``dropout_seed`` given; its
        mask drawn for the global batch and cut to ``rows`` where given) and,
        as any forward autograd records through, keeps the plain path."""
        h, w = x.shape[1], x.shape[2]
        f = {"up": 2.0, "down": 0.5}.get(self.resample_mode, 1.0)
        kernels = not training and not autograd_live(x, emb, skip, *self.parameters())
        fused = (kernels and self.block_kernels and self.kernel_block
                 and (h * f) * (w * f) >= FUSED_MIN_PIXELS)
        # the parameter-free nearest-up runs inside the fused kernel
        defer_up = (fused and self.resample_mode == "up" and skip is None
                    and self.resample is None)
        if self.resample is not None:
            x = self.resample(x, self.resample_skip_weight)
        elif not defer_up:
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
        act = self.act
        if self.conv_type == "mobile":
            y = self.conv_res0[1](act(self.conv_res0[0](act(x))))
        else:
            y = self.conv_res0(act(x))
        if self.emb_linear is not None and emb is not None:
            y = act(y * self._emb_scale(emb)[:, None, None, :].to(y.dtype))
        else:
            y = act(y)
        if training and self.dropout > 0 and dropout_seed is not None:
            mask_gen = torch.Generator(device=y.device).manual_seed(int(dropout_seed))
            shape = y.shape if rows is None else (rows.total, *y.shape[1:])
            keep = torch.rand(shape, generator=mask_gen, device=y.device) < 1.0 - self.dropout
            keep = keep if rows is None else rows.take(keep)
            y = torch.where(keep, y / (1.0 - self.dropout), 0.0)
        y = self.conv_res1(y)
        if self.mode == "dec" and self.conv_skip is not None:
            x = self.conv_skip(x)
        if x.shape[1:3] != y.shape[1:3]:  # no_padding: crop the residual
            dh, dw = x.shape[1] - y.shape[1], x.shape[2] - y.shape[2]
            x = x[:, dh // 2:x.shape[1] - (dh - dh // 2), dw // 2:x.shape[2] - (dw - dw // 2)]
        x = mp.mp_sum([x, y], w=self.res_balance)
        if self.num_heads > 0:
            x = mp.mp_sum([x, self._attention(x, kernels)], w=self.attn_balance)
        if self.clip_act is not None:
            x = torch.clamp(x, -self.clip_act, self.clip_act)
        return x
