"""The EDM2 magnitude-preserving U-Net, plain PyTorch, NHWC activations.

Frozen copy of the port's plain path (``nn/edm_unet.py``, ``nn/layers.py``,
``ops/mp.py``, ``ops/attention.py::pixelnorm_attention_reference``), forward
only, float32, with the parameter and buffer names of the port's state dict
so that one state dict loads into both.  No hand-written kernel, no 16-bit
path, no dropout.

``quant`` (a key of ``QUANTIZERS``) rounds both operands of every
convolution and matmul: "none" for the reference itself, "tf32" and "fp8"
for the lower-precision controls of the float32 and the bf16 world.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32's 10 mantissa bits, to nearest even."""
    bits = x.float().contiguous().view(torch.int32)
    bits = (bits + 0xFFF + ((bits >> 13) & 1)) & ~0x1FFF
    return bits.view(torch.float32)


def _fp8(x: torch.Tensor) -> torch.Tensor:
    """float32 through float8 e4m3 with one scale a tensor (amax to 448)."""
    x = x.float()
    scale = x.abs().amax().clamp(min=1e-30) / 448.0
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


QUANTIZERS = {"none": lambda x: x, "tf32": _tf32, "fp8": _fp8}


def normalize(x: torch.Tensor, dim=None, eps: float = 1e-4) -> torch.Tensor:
    if dim is None:
        norm = torch.sqrt(torch.sum(x * x))
        return x / (eps + norm * math.sqrt(1.0 / x.numel()))
    norm = torch.sqrt(torch.sum(x * x, dim=dim, keepdim=True))
    return x / (eps + norm * math.sqrt(1.0 / x.shape[dim]))


def mp_silu(x):
    return (x * torch.sigmoid(x)) / 0.596


def _weights(n, w):
    if w is None:
        return np.full((n,), 1.0 / n)
    if isinstance(w, float):
        return np.array([1.0 - w, w])
    return np.asarray(w, dtype=np.float64)


def mp_sum(args, w=None):
    wv = _weights(len(args), w)
    out = args[0] * float(wv[0])
    for a, wi in zip(args[1:], wv[1:]):
        out = out + a * float(wi)
    return out / float(np.linalg.norm(wv))


def mp_concat(args, dim=-1, w=None):
    n_ch = [a.shape[dim] for a in args]
    wv = _weights(len(args), w)
    c = math.sqrt(sum(n_ch) / float(np.sum(wv ** 2)))
    return torch.cat([a * float(c / math.sqrt(n) * wv[i]) for i, (a, n) in
                      enumerate(zip(args, n_ch))], dim=dim)


class MPConv(nn.Module):
    def __init__(self, cin, cout, kernel=(), *, device, quant):
        super().__init__()
        self.quant = quant
        self.weight = nn.Parameter(torch.empty((cout, cin, *kernel), device=device),
                                   requires_grad=False)

    def forward(self, x, gain=1.0):
        w = normalize(self.weight) * (gain / math.sqrt(self.weight[0].numel()))
        q = QUANTIZERS[self.quant]
        x, w = q(x), q(w)
        if w.dim() == 2:
            return x @ w.t()
        return conv_nhwc(x, w)


def conv_nhwc(x, w):
    """SAME k x k convolution of NHWC ``x`` by an OIHW ``w`` as one matmul a
    tap (cuBLAS, float32), summed: no convolution library is asked to choose
    an algorithm."""
    n, h, wd, c = x.shape
    k = w.shape[-1]
    taps = w.permute(2, 3, 1, 0)  # (k, k, in, out)
    if k == 1:
        return (x.reshape(-1, c) @ taps[0, 0]).reshape(n, h, wd, -1)
    p = k // 2
    xp = F.pad(x, (0, 0, p, p, p, p))
    out = None
    for dy in range(k):
        for dx in range(k):
            y = xp[:, dy:dy + h, dx:dx + wd, :].reshape(-1, c) @ taps[dy, dx]
            out = y if out is None else out + y
    return out.reshape(n, h, wd, -1)


class MPFourier(nn.Module):
    def __init__(self, n, *, device):
        super().__init__()
        self.register_buffer("freqs", torch.empty(n, device=device))
        self.register_buffer("phases", torch.empty(n, device=device))

    def forward(self, x):
        return torch.cos(x.float()[..., None] * self.freqs + self.phases) * math.sqrt(2.0)


def positional_freqs(n: int) -> np.ndarray:
    half = n // 2
    return np.exp(np.arange(half) * -(math.log(10) / (half - 1))).astype(np.float32)


class MPPositional(nn.Module):
    def __init__(self, n, *, device):
        super().__init__()
        self.register_buffer("freqs", torch.from_numpy(positional_freqs(n)).to(device),
                             persistent=False)

    def forward(self, x):
        y = x.float()[..., None] * self.freqs
        return torch.cat([torch.sin(y), torch.cos(y)], dim=-1) * math.sqrt(2.0)


def attention(qkv, heads, quant, eps=1e-4):
    """Pixel-norm attention; qkv channels laid out (head, channel, qkv)."""
    n, h, w, c3 = qkv.shape
    c = c3 // 3
    ch = c // heads
    y = qkv.reshape(n, h * w, heads, ch, 3).permute(0, 2, 3, 4, 1)
    y = y / (eps + torch.sqrt(torch.sum(y * y, dim=2, keepdim=True)) * math.sqrt(1.0 / ch))
    q = QUANTIZERS[quant]
    qq, k, v = (y[:, :, :, i] for i in range(3))
    wts = torch.softmax(torch.einsum("nhcq,nhck->nhqk", q(qq), q(k / math.sqrt(ch))), dim=3)
    out = torch.einsum("nhqk,nhck->nhcq", q(wts), q(v))
    return out.permute(0, 3, 1, 2).reshape(n, h, w, c)


class UNetBlock(nn.Module):
    def __init__(self, cin, cout, emb_ch, *, device, quant, mode="enc", resample_mode="keep",
                 attention=False, channels_per_head=64, res_balance=0.3, attn_balance=0.3,
                 clip_act=256.0, **_unused):
        super().__init__()
        self.mode, self.resample_mode = mode, resample_mode
        self.res_balance, self.attn_balance, self.clip_act = res_balance, attn_balance, clip_act
        self.quant = quant
        self.num_heads = cout // channels_per_head if attention else 0
        kw = dict(device=device, quant=quant)
        self.emb_gain = nn.Parameter(torch.empty((), device=device), requires_grad=False)
        self.conv_res0 = MPConv(cout if mode == "enc" else cin, cout, (3, 3), **kw)
        self.emb_linear = MPConv(emb_ch, cout, (), **kw) if emb_ch > 0 else None
        self.conv_res1 = MPConv(cout, cout, (3, 3), **kw)
        self.conv_skip = MPConv(cin, cout, (1, 1), **kw) if cin != cout else None
        if self.num_heads > 0:
            self.attn_qkv = MPConv(cout, cout * 3, (1, 1), **kw)
            self.attn_proj = MPConv(cout, cout, (1, 1), **kw)

    def forward(self, x, emb, skip=None, concat_w=0.3):
        if self.resample_mode == "down":
            x = x[:, ::2, ::2, :]
        elif self.resample_mode == "up":
            x = x.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)
        if skip is not None:
            x = mp_concat([x, skip], dim=-1, w=concat_w)
        if self.mode == "enc":
            if self.conv_skip is not None:
                x = self.conv_skip(x)
            x = normalize(x, dim=-1)
        y = self.conv_res0(mp_silu(x))
        if self.emb_linear is not None and emb is not None:
            c = self.emb_linear(emb, gain=self.emb_gain) + 1.0
            c = c / torch.sqrt(torch.mean(c * c, dim=-1, keepdim=True) + 1e-8)
            y = y * c[:, None, None, :]
        y = self.conv_res1(mp_silu(y))
        if self.mode == "dec" and self.conv_skip is not None:
            x = self.conv_skip(x)
        x = mp_sum([x, y], w=self.res_balance)
        if self.num_heads > 0:
            att = self.attn_proj(attention(self.attn_qkv(x), self.num_heads, self.quant))
            x = mp_sum([x, att], w=self.attn_balance)
        if self.clip_act is not None:
            x = torch.clamp(x, -self.clip_act, self.clip_act)
        return x


def plan(cfg: dict):
    """(enc, dec, final channels, out channels, emb channels, noise dims):
    the module-name graph of the reference U-Net."""
    mults = list(cfg.get("model_channel_mults") or (1, 2, 3, 4))
    emb = cfg.get("emb_channels") or cfg["model_channels"] * max(mults)
    noise_dims = cfg.get("noise_emb_dims")
    noise_dims = cfg["model_channels"] if noise_dims is None else noise_dims
    out_ch = cfg.get("out_channels") or cfg["in_channels"]
    lpb = cfg.get("layers_per_block", 2)
    lpb = [lpb] * len(mults) if isinstance(lpb, int) else list(lpb)
    conds = cfg.get("conditional_inputs") or []
    if noise_dims == 0 and not conds:
        emb = 0
    attn_res = list(cfg.get("attn_resolutions") or [])
    chans = [cfg["model_channels"] * m for m in mults]
    enc, cout = [], cfg["in_channels"] + 1
    for level, (ch, nb) in enumerate(zip(chans, lpb)):
        res = cfg["image_size"] // 2 ** level
        if level == 0:
            enc.append((f"{res}x{res}_conv", "conv", cout, ch, {}))
            cout = ch
        else:
            enc.append((f"{res}x{res}_down", "block", cout, cout,
                        dict(mode="enc", resample_mode="down")))
        for idx in range(nb):
            enc.append((f"{res}x{res}_block{idx}", "block", cout, ch,
                        dict(mode="enc", attention=res in attn_res)))
            cout = ch
    dec, skips = [], [e[3] for e in enc]
    for level, (ch, nb) in reversed(list(enumerate(zip(chans, lpb)))):
        res = cfg["image_size"] // 2 ** level
        if level == len(chans) - 1:
            dec.append((f"{res}x{res}_in0", "block", cout, cout,
                        dict(mode="dec", attention=cfg.get("midblock_attention", True))))
            dec.append((f"{res}x{res}_in1", "block", cout, cout, dict(mode="dec")))
        else:
            dec.append((f"{res}x{res}_up", "block", cout, cout,
                        dict(mode="dec", resample_mode="up")))
        for idx in range(nb + 1):
            cin = cout + skips.pop()
            dec.append((f"{res}x{res}_block{idx}", "block", cin, ch,
                        dict(mode="dec", attention=res in attn_res)))
            cout = ch
    return enc, dec, cout, out_ch, emb, noise_dims


class UNet(nn.Module):
    """``UNet(cfg, device=, quant=)``: ``forward(x NHWC, noise_labels,
    conditional_inputs)``; the weights come from ``load_state_dict``."""

    def __init__(self, cfg: dict, *, device, quant: str = "none"):
        super().__init__()
        self.cfg = cfg
        self.enc_plan, self.dec_plan, final_ch, out_ch, emb, self.noise_dims = plan(cfg)
        kw = dict(device=device, quant=quant)
        if cfg.get("fourier_scale", 1) != "pos":
            raise ValueError("the world's models use the positional noise embedding")
        if self.noise_dims > 0:
            self.noise_fourier = MPPositional(self.noise_dims, device=device)
            self.noise_linear = MPConv(self.noise_dims, emb, (), **kw)
        cond = []
        for typ, n, _w in cfg.get("conditional_inputs") or []:
            if typ == "float":
                cond.append(nn.Sequential(MPFourier(n, device=device), MPConv(n, emb, (), **kw)))
            elif typ == "tensor":
                cond.append(MPConv(n, emb, (), **kw))
            else:
                raise ValueError(f"conditional input {typ!r} is not in the world's models")
        self.conditional_layers = nn.ModuleList(cond)
        self.out_gain = nn.Parameter(torch.empty((), device=device), requires_grad=False)
        bkw = {k: v for k, v in (cfg.get("block_kwargs") or {}).items()
               if k in ("channels_per_head", "res_balance", "attn_balance", "clip_act")}
        self.enc = nn.ModuleDict()
        for name, kind, cin, cout, opts in self.enc_plan:
            self.enc[name] = (MPConv(cin, cout, (3, 3), **kw) if kind == "conv" else
                              UNetBlock(cin, cout, emb, **kw, **bkw, **opts))
        self.dec = nn.ModuleDict({name: UNetBlock(cin, cout, emb, **kw, **bkw, **opts)
                                  for name, _k, cin, cout, opts in self.dec_plan})
        self.out_conv = MPConv(final_ch, out_ch, (3, 3), **kw)
        n_lv = cfg.get("logvar_channels", 128)
        self.logvar_fourier = MPFourier(n_lv, device=device)  # unused by sampling
        self.logvar_linear = MPConv(n_lv, cfg.get("n_logvar", 1), (), **kw)

    def forward(self, x, noise_labels, conditional_inputs=()):
        embeds, weights = [], []
        if self.noise_dims > 0:
            embeds.append(self.noise_linear(self.noise_fourier(noise_labels)))
            weights.append(1.0)
        for (typ, _n, w), layer, ci in zip(self.cfg.get("conditional_inputs") or [],
                                          self.conditional_layers, conditional_inputs):
            e = layer(ci)
            embeds.append(mp_silu(e) if typ == "tensor" else e)
            weights.append(float(w))
        emb = mp_silu(mp_sum(embeds, weights)) if embeds else None
        x = torch.cat([x, torch.ones_like(x[..., :1])], dim=-1)
        skips = []
        for name, kind, *_ in self.enc_plan:
            x = self.enc[name](x) if kind == "conv" else self.enc[name](x, emb)
            skips.append(x)
        for name, *_ in self.dec_plan:
            skip = skips.pop() if "block" in name else None
            x = self.dec[name](x, emb, skip, concat_w=self.cfg.get("concat_balance", 0.3))
        return self.out_conv(x, gain=self.out_gain)
