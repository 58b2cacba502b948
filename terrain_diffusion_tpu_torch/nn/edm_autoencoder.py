"""EDMAutoencoder: a VAE with an EDMUnet2D encoder and an MP-block decoder,
as an ``nn.Module`` (counterpart of ``terrain_diffusion_tpu.nn.edm_autoencoder``).

The encoder is an encode-only ``EDMUnet2D`` producing 2 x latent_channels
(means ++ logvars); the decoder is a 1x1 conv from the latent (plus a ones
channel) and a stack of ``UNetBlock``s in the JAX package's
``_decoder_plan`` order, then a 3x3 ``out_conv`` scaled by ``out_gain``.
Direct-skip channels ride through the latent losslessly (avg-pooled in,
nearest re-injected out).  Parameter names are the reference state-dict
names (``encoder.enc.512x512_conv.weight``, ``decoder.3.conv_res0.weight``,
``out_gain``, ``logvar``), so a reference checkpoint loads as it is.

Kernel routing is the blocks' (``nn/layers.py``): on the card every
encoder and decoder block whose output map has at least 128 x 128 pixels
runs the fused-block kernel, and the encoder's in conv the 3x3-conv
kernel; the decoder's ``out_conv`` stays an ``MPConv``, as JAX computes
it with ``mp_conv_apply`` outside any Pallas kernel.  ``with_block_impl(ae,
"xla")`` turns the block and conv kernels off in the encoder and the
decoder alike (the switch is on each block and on the encoder).
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Optional

import torch
from torch import nn

from terrain_diffusion_tpu_torch.nn.edm_unet import EDMUnet2D, EDMUnetConfig
from terrain_diffusion_tpu_torch.nn.layers import MPConv, UNetBlock
from terrain_diffusion_tpu_torch.ops.image import avg_pool, upsample_nearest
from terrain_diffusion_tpu_torch.ops.noise_field import normal


@dataclasses.dataclass(frozen=True)
class EDMAutoencoderConfig:
    image_size: int
    in_channels: int
    latent_channels: int
    out_channels: Optional[int] = None
    model_channels: int = 128
    model_channel_mults: tuple = (1, 2, 3, 4)
    layers_per_block: Any = 3
    layers_per_block_decoder: Any = None
    attn_resolutions: tuple = ()
    midblock_attention: bool = True
    logvar_channels: int = 128
    block_kwargs: Any = dataclasses.field(default_factory=dict)
    conditional_inputs: tuple = ()
    n_logvar: int = 1
    direct_skips: tuple = ()

    def resolved(self):
        mults = tuple(self.model_channel_mults or (1, 2, 3, 4))
        out_ch = self.out_channels or self.in_channels
        lpb = self.layers_per_block
        if isinstance(lpb, int):
            lpb = [lpb] * len(mults)
        lpbd = self.layers_per_block_decoder or lpb
        if isinstance(lpbd, int):
            lpbd = [lpbd] * len(mults)
        return mults, tuple(lpb), tuple(lpbd), out_ch

    @classmethod
    def from_dict(cls, d: dict) -> "EDMAutoencoderConfig":
        fields = {f.name for f in dataclasses.fields(cls)}
        kw = {k: v for k, v in d.items() if k in fields}
        for key in ("model_channel_mults", "attn_resolutions", "direct_skips"):
            if kw.get(key) is not None:
                kw[key] = tuple(kw[key])
        if kw.get("block_kwargs") is None:
            kw["block_kwargs"] = {}
        return cls(**kw)

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["_class_name"] = "EDMAutoencoder"
        if isinstance(d.get("block_kwargs"), dict):  # runtime backend selectors
            d["block_kwargs"] = {k: v for k, v in d["block_kwargs"].items()
                                 if k not in ("block_impl", "attention_impl")}
        return d


def decoder_plan(cfg: EDMAutoencoderConfig):
    """(name, cin, cout, opts) of every decoder block, the final width and
    the output channels (JAX ``_decoder_plan``)."""
    mults, _lpb, lpbd, out_ch = cfg.resolved()
    block_channels = [cfg.model_channels * m for m in mults]
    plan = []
    cout = cfg.model_channels * mults[-1]
    for level, (channels, nb) in reversed(list(enumerate(zip(block_channels, lpbd)))):
        res = cfg.image_size // 2 ** level
        if level == len(block_channels) - 1:
            plan.append(("mid0", cout, cout, dict(mode="dec", attention=cfg.midblock_attention)))
            plan.append(("mid1", cout, cout, dict(mode="dec")))
        else:
            plan.append((f"up{level}", cout, cout, dict(mode="dec", resample_mode="up")))
        for idx in range(nb + 1):
            cin, cout = cout, channels
            plan.append((f"{res}x{res}_b{idx}", cin, cout,
                         dict(mode="dec", attention=res in cfg.attn_resolutions)))
    return plan, cout, out_ch


class EDMAutoencoder(nn.Module):
    def __init__(self, config: EDMAutoencoderConfig, *, device, generator: torch.Generator):
        super().__init__()
        self.config = cfg = config
        mults, lpb, _lpbd, _out = config.resolved()
        kw = dict(device=device, generator=generator)
        self.encoder = EDMUnet2D(EDMUnetConfig(
            image_size=cfg.image_size, in_channels=cfg.in_channels,
            out_channels=cfg.latent_channels * 2, model_channels=cfg.model_channels,
            model_channel_mults=mults, layers_per_block=list(lpb), emb_channels=0,
            noise_emb_dims=0, attn_resolutions=cfg.attn_resolutions,
            midblock_attention=cfg.midblock_attention, logvar_channels=cfg.logvar_channels,
            block_kwargs=cfg.block_kwargs, conditional_inputs=cfg.conditional_inputs,
            encode_only=True, disable_out_gain=False), **kw)
        with torch.no_grad():  # the reference sets the encoder's out_gain to one
            self.encoder.out_gain.fill_(1.0)
        self.decoder_plan, final_ch, self.out_ch = decoder_plan(cfg)
        latent_in = cfg.latent_channels + len(cfg.direct_skips) + 1
        self.decoder_conv = MPConv(latent_in, cfg.model_channels * mults[-1], (1, 1), **kw)
        self.decoder = nn.ModuleList(
            UNetBlock(cin, cout, 0, **kw, **{**cfg.block_kwargs, **opts})
            for _name, cin, cout, opts in self.decoder_plan)
        self.out_conv = MPConv(final_ch, self.out_ch, (3, 3), **kw)
        self.out_gain = nn.Parameter(torch.full((), 0.1, device=device))
        self.logvar = nn.Parameter(torch.zeros((cfg.n_logvar,), device=device))

    def preencode(self, x, conditional_inputs=None, compute_dtype=None):
        """x (N, H, W, C) -> (means, logvars), NHWC; direct-skip channels
        appended to the means as avg-pooled copies (logvar -20)."""
        cfg = self.config
        x = x.to(compute_dtype or x.dtype)
        enc = self.encoder(x, None, conditional_inputs)
        means, logvars = torch.chunk(enc, 2, dim=-1)
        factor = x.shape[1] // means.shape[1]
        extra = [avg_pool(x[..., ch:ch + 1].permute(0, 3, 1, 2), factor).permute(0, 2, 3, 1)
                 for ch in cfg.direct_skips]
        if extra:
            means = torch.cat([means, *extra], dim=-1)
            pad = torch.full((*logvars.shape[:-1], len(extra)), -20.0, dtype=logvars.dtype,
                             device=logvars.device)
            logvars = torch.cat([logvars, pad], dim=-1)
        return means, logvars

    @staticmethod
    def postencode(means, logvars, key=None, use_mode: bool = False, rows=None):
        """A latent sample; ``key`` is a threefry key (``ops/noise_field.py``),
        and without one (or with ``use_mode``) the means.  With ``rows``
        (data-parallel training) the noise is drawn for the global batch
        and cut to the rows the means hold."""
        if use_mode or key is None:
            return means
        std = torch.exp(logvars * 0.5)
        if rows is None:
            eps = normal(key, std.shape, std.device)
        else:
            eps = rows.take(normal(key, (rows.total, *std.shape[1:]), std.device))
        return means + eps.to(std.dtype) * std

    def decode(self, z, include_logvar: bool = False, compute_dtype=None):
        """z (N, h, w, latent + skips) -> (N, H, W, out_ch)."""
        cfg = self.config
        dt = compute_dtype or z.dtype
        direct = z[..., cfg.latent_channels:]
        z = torch.cat([z, torch.ones_like(z[..., :1])], dim=-1).to(dt)
        z = self.decoder_conv(z)
        for block in self.decoder:
            z = block(z, None)
        out = self.out_conv(z, gain=self.out_gain)
        if cfg.direct_skips:
            factor = out.shape[1] // direct.shape[1]
            used = {int(c): i for i, c in enumerate(cfg.direct_skips)}
            chans = []
            for c in range(out.shape[-1]):
                if c in used:
                    d = direct[..., used[c]:used[c] + 1].permute(0, 3, 1, 2)
                    chans.append(upsample_nearest(d, factor)[:, 0].to(out.dtype))
                else:
                    chans.append(out[..., c])
            out = torch.stack(chans, dim=-1)
        if include_logvar:
            return out, self.logvar.reshape(-1, 1, 1, 1)
        return out

    def save_config(self, directory: str):
        os.makedirs(directory, exist_ok=True)
        with open(os.path.join(directory, "config.json"), "w") as f:
            json.dump(self.config.to_dict(), f, indent=2)

    def count_parameters(self) -> int:
        return int(sum(p.numel() for p in self.parameters()))
