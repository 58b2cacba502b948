"""EDMUnet2D: EDM2-style magnitude-preserving U-Net as an ``nn.Module``.

Counterpart of ``terrain_diffusion_tpu.nn.edm_unet``: the same block graph
(``_enc_dec_plan``), conditioning (noise fourier/positional embedding plus
float/tensor/embedding conditional inputs with mp_sum weighting), the
ones-channel bias surrogate, mp_concat skips and the logvar head.  Module
and parameter names are the reference state-dict names, e.g.
``enc.512x512_block0.conv_res0.weight``.  Activations are NHWC.

The input and output 3x3 convs on maps of at least 128 x 128 pixels run
through the hand-written conv kernel (``ops/fused_block.py::conv3x3``),
except in a training forward or one autograd records through, which runs
the plain path throughout (``nn/layers.py``), and except where the
model's ``block_kernels`` switch is off (``layers.with_block_impl``).
``forward(training=True, generator=g)`` mirrors JAX's
``apply(training=True, dropout_key=k)``: one
dropout seed a plan entry is drawn from ``g``, in plan order, as
``jax.random.split(dropout_key, n_blocks)`` gives one key each.
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Optional

import numpy as np
import torch
from torch import nn

from terrain_diffusion_tpu_torch.ops import mp
from terrain_diffusion_tpu_torch.ops.cuda_lib import autograd_live
from terrain_diffusion_tpu_torch.ops.fused_block import conv3x3
from terrain_diffusion_tpu_torch.ops.nhwc import oihw_to_hwio
from terrain_diffusion_tpu_torch.nn.layers import (FUSED_MIN_PIXELS, MPConv,
                                                   MPEmbedding, MPFourier,
                                                   MPPositional, UNetBlock)


@dataclasses.dataclass(frozen=True)
class EDMUnetConfig:
    image_size: int
    in_channels: int
    out_channels: Optional[int] = None
    model_channels: int = 128
    model_channel_mults: tuple = (1, 2, 3, 4)
    layers_per_block: Any = 2
    emb_channels: Optional[int] = None
    noise_emb_dims: Optional[int] = None
    attn_resolutions: tuple = ()
    midblock_attention: bool = True
    concat_balance: float = 0.3
    logvar_channels: int = 128
    block_kwargs: Any = dataclasses.field(default_factory=dict)
    conditional_inputs: tuple = ()  # ((type, x, weight), ...)
    encode_only: bool = False
    disable_out_gain: bool = False
    fourier_scale: Any = 1
    n_logvar: int = 1

    def resolved(self):
        mults = tuple(self.model_channel_mults or (1, 2, 3, 4))
        emb = self.emb_channels or self.model_channels * max(mults)
        noise_dims = self.model_channels if self.noise_emb_dims is None else self.noise_emb_dims
        out_ch = self.out_channels or self.in_channels
        lpb = self.layers_per_block
        if isinstance(lpb, int):
            lpb = [lpb] * len(mults)
        if noise_dims == 0 and len(self.conditional_inputs) == 0:
            emb = 0
        return mults, emb, noise_dims, tuple(lpb), out_ch

    @classmethod
    def from_dict(cls, d: dict) -> "EDMUnetConfig":
        fields = {f.name for f in dataclasses.fields(cls)}
        kw = {k: v for k, v in d.items() if k in fields}
        for key in ("model_channel_mults", "attn_resolutions"):
            if kw.get(key) is not None:
                kw[key] = tuple(kw[key])
        if kw.get("conditional_inputs"):
            kw["conditional_inputs"] = tuple(tuple(ci) for ci in kw["conditional_inputs"])
        if kw.get("block_kwargs") is None:
            kw["block_kwargs"] = {}
        return cls(**kw)

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["_class_name"] = "EDMUnet2D"
        return d


def _enc_dec_plan(cfg: EDMUnetConfig):
    """The reference's module-name graph: (name, kind, in, out, opts) lists."""
    mults, emb, noise_dims, lpb, out_ch = cfg.resolved()
    block_channels = [cfg.model_channels * m for m in mults]
    enc = []
    cout = cfg.in_channels + 1
    for level, (channels, nb) in enumerate(zip(block_channels, lpb)):
        res = cfg.image_size // 2 ** level
        if level == 0:
            cin, cout = cout, channels
            enc.append((f"{res}x{res}_conv", "conv", cin, cout, {}))
        else:
            enc.append((f"{res}x{res}_down", "block", cout, cout,
                        dict(mode="enc", resample_mode="down")))
        for idx in range(nb):
            cin, cout = cout, channels
            enc.append((f"{res}x{res}_block{idx}", "block", cin, cout,
                        dict(mode="enc", attention=res in cfg.attn_resolutions)))
    dec = []
    skips = [e[3] for e in enc]
    if not cfg.encode_only:
        for level, (channels, nb) in reversed(list(enumerate(zip(block_channels, lpb)))):
            res = cfg.image_size // 2 ** level
            if level == len(block_channels) - 1:
                dec.append((f"{res}x{res}_in0", "block", cout, cout,
                            dict(mode="dec", attention=cfg.midblock_attention)))
                dec.append((f"{res}x{res}_in1", "block", cout, cout, dict(mode="dec")))
            else:
                dec.append((f"{res}x{res}_up", "block", cout, cout,
                            dict(mode="dec", resample_mode="up")))
            for idx in range(nb + 1):
                cin = cout + skips.pop()
                cout = channels
                dec.append((f"{res}x{res}_block{idx}", "block", cin, cout,
                            dict(mode="dec", attention=res in cfg.attn_resolutions)))
    return enc, dec, cout, out_ch, emb, noise_dims


class EDMUnet2D(nn.Module):
    block_kernels = True  # the 3x3-conv kernel on the in / out conv (with_block_impl)

    def __init__(self, config: EDMUnetConfig, *, device,
                 generator: torch.Generator):
        super().__init__()
        self.config = cfg = config
        (self.enc_plan, self.dec_plan, final_ch, self.out_ch, self.emb_ch,
         self.noise_dims) = _enc_dec_plan(config)
        kw = dict(device=device, generator=generator)
        if self.noise_dims > 0:
            self.noise_fourier = (MPPositional(self.noise_dims, device=device)
                                  if cfg.fourier_scale == "pos" else
                                  MPFourier(self.noise_dims, float(cfg.fourier_scale), **kw))
            self.noise_linear = MPConv(self.noise_dims, self.emb_ch, (), **kw)
        cond = []
        for typ, x, _w in cfg.conditional_inputs:
            if typ == "float":
                cond.append(nn.Sequential(MPFourier(x, **kw),
                                          MPConv(x, self.emb_ch, (), **kw)))
            elif typ == "tensor":
                cond.append(MPConv(x, self.emb_ch, (), **kw))
            elif typ == "embedding":
                cond.append(MPEmbedding(x, self.emb_ch, **kw))
            else:
                raise ValueError(f"unknown conditional input type {typ}")
        self.conditional_layers = nn.ModuleList(cond)
        if not cfg.disable_out_gain:
            self.out_gain = nn.Parameter(torch.zeros((), device=device))
        self.enc = nn.ModuleDict()
        for name, kind, cin, cout, opts in self.enc_plan:
            if kind == "conv":
                self.enc[name] = MPConv(cin, cout, (3, 3), **kw)
            else:
                self.enc[name] = UNetBlock(cin, cout, self.emb_ch, **kw,
                                           **{**cfg.block_kwargs, **opts})
        self.dec = nn.ModuleDict()
        for name, kind, cin, cout, opts in self.dec_plan:
            self.dec[name] = UNetBlock(cin, cout, self.emb_ch, **kw,
                                       **{**cfg.block_kwargs, **opts})
        self.out_conv = MPConv(final_ch, self.out_ch, (3, 3), **kw)
        self.logvar_fourier = MPFourier(cfg.logvar_channels, **kw)
        self.logvar_linear = MPConv(cfg.logvar_channels, cfg.n_logvar, (), **kw)

    def compute_embeddings(self, noise_labels, conditional_inputs):
        cfg = self.config
        conditional_inputs = conditional_inputs or []
        embeds, weights = [], []
        if self.noise_dims > 0:
            embeds.append(self.noise_linear(self.noise_fourier(noise_labels)))
            weights.append(1.0)
        for i, (typ, _x, w) in enumerate(cfg.conditional_inputs):
            layer, ci = self.conditional_layers[i], conditional_inputs[i]
            e = mp.mp_silu(layer(ci)) if typ == "tensor" else layer(ci)
            embeds.append(e)
            weights.append(float(w))
        if not embeds:
            return None
        return mp.mp_silu(mp.mp_sum(embeds, weights))

    def forward(self, x, noise_labels=None, conditional_inputs=None,
                return_logvar: bool = False, training: bool = False,
                generator: Optional[torch.Generator] = None, rows=None):
        """x is NHWC (N, H, W, in_channels).  ``training`` with a CPU
        ``generator`` applies the blocks' dropout (for the ``rows`` of the
        global batch that x holds, in data-parallel training)."""
        cfg = self.config
        emb = self.compute_embeddings(noise_labels, conditional_inputs)
        if emb is not None:
            emb = emb.to(x.dtype)
        x = torch.cat([x, torch.ones_like(x[..., :1])], dim=-1)
        n_plan = len(self.enc_plan) + len(self.dec_plan)
        seeds = ([None] * n_plan if not (training and generator is not None) else
                 torch.randint(0, 2 ** 62, (n_plan,), generator=generator).tolist())
        seeds = iter(seeds)
        skips = []
        for name, kind, _cin, _cout, _opts in self.enc_plan:
            seed = next(seeds)
            if kind == "conv":
                x = self._conv3x3(self.enc[name], x, training=training)
            else:
                x = self.enc[name](x, emb, training=training, dropout_seed=seed, rows=rows)
            skips.append(x)
        for name, _kind, _cin, _cout, _opts in self.dec_plan:
            skip = skips.pop() if "block" in name else None
            x = self.dec[name](x, emb, skip, concat_w=cfg.concat_balance, training=training,
                               dropout_seed=next(seeds), rows=rows)
        x = self._conv3x3(self.out_conv, x, getattr(self, "out_gain", None), training)
        if return_logvar:
            lv_in = torch.log(torch.tan(noise_labels) / 8.0)
            logvar = self.logvar_linear(self.logvar_fourier(lv_in))
            return x, logvar.reshape(-1, 1, 1, cfg.n_logvar)
        return x

    def _conv3x3(self, conv: MPConv, x, gain=None, training: bool = False):
        """The in/out 3x3 conv: the hand-written kernel on large maps, but in
        a training forward, one autograd records through, or with the
        model's ``block_kernels`` off."""
        gain = 1.0 if gain is None else gain
        if self.block_kernels and x.shape[1] * x.shape[2] >= FUSED_MIN_PIXELS and not training \
                and not autograd_live(x, conv.weight, gain):
            w = oihw_to_hwio(conv.prepared_weight(gain)).contiguous()
            return conv3x3(x.contiguous(), w)
        return conv(x, gain=gain)

    def save_config(self, directory: str):
        os.makedirs(directory, exist_ok=True)
        with open(os.path.join(directory, "config.json"), "w") as f:
            json.dump(self.config.to_dict(), f, indent=2)

    def count_parameters(self) -> int:
        return int(sum(np.prod(p.shape) for p in self.parameters()))
