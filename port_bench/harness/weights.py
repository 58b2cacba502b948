"""Random weights of the three stage models, made on the device from the seed.

One state dict a model, with the port's names, drawn in two calls on a
generator of the device (one normal and one uniform draw, sliced): the conv,
linear and Fourier-frequency tensors standard normal (the models normalize
their weights in every forward), Fourier frequencies times 2 pi, phases
uniform on [0, 2 pi), each block's ``emb_gain`` normal times 0.5 and
``out_gain`` 1.  The initial gains of 0 would make every network constant.
The same dicts go to the port and to the reference; the positional
embedding's fixed frequency table, which the port keeps as a buffer, is
added for the port alone (the reference computes it itself).
"""
from __future__ import annotations

import math

import torch

STAGES = ("coarse", "base", "decoder")


def _shapes(model_cfg: dict) -> dict:
    from reference.unet import UNet

    with torch.device("meta"):
        m = UNet(model_cfg, device="meta")
    return {k: tuple(v.shape) for k, v in m.state_dict().items()}


def make(model_cfgs: dict, seed: int, device) -> dict:
    """{stage: {name: float32 tensor on device}} for the three models."""
    device = torch.device(device)
    shapes = {s: _shapes(model_cfgs[s]) for s in STAGES}
    normal = [(s, k, sh) for s in STAGES for k, sh in shapes[s].items()
              if not k.endswith("phases")]
    uniform = [(s, k, sh) for s in STAGES for k, sh in shapes[s].items()
               if k.endswith("phases")]
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) & 0xFFFFFFFFFFFFFFFF)
    n_total = sum(math.prod(sh) for _, _, sh in normal)
    u_total = sum(math.prod(sh) for _, _, sh in uniform)
    draws = {"n": torch.randn(n_total, generator=g, device=device),
             "u": torch.rand(u_total, generator=g, device=device)}
    out = {s: {} for s in STAGES}
    for kind, entries in (("n", normal), ("u", uniform)):
        off = 0
        for s, k, sh in entries:
            n = math.prod(sh)
            out[s][k] = draws[kind][off:off + n].reshape(sh)
            off += n
    for s in STAGES:
        for k, t in out[s].items():
            if k.endswith("emb_gain"):
                out[s][k] = t * 0.5
            elif k == "out_gain":
                out[s][k] = torch.ones_like(t)
            elif k.endswith("freqs"):
                out[s][k] = t * (2 * math.pi)
            elif k.endswith("phases"):
                out[s][k] = t * (2 * math.pi)
    return out


def for_port(state: dict, model_cfg: dict) -> dict:
    """The state dict with the port's positional-embedding buffer."""
    from reference.unet import positional_freqs, plan

    noise_dims = plan(model_cfg)[5]
    sd = dict(state)
    if noise_dims > 0:
        some = next(iter(state.values()))
        sd["noise_fourier.freqs"] = torch.from_numpy(positional_freqs(noise_dims)).to(some.device)
    return sd
