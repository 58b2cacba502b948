"""Perceptron (MLP), the biome auxiliary model, as an ``nn.Module``
(counterpart of ``terrain_diffusion_tpu.nn.perceptron``).

A config-driven MLP with optional random ensembles.  Each ensemble member is
an ``nn.Sequential`` of Linear, activation and (with ``dropout``) Dropout
modules, so the state dict has the reference's names
(``nets.{k}.{2i}.weight`` without dropout, ``nets.{k}.{3i}.weight`` with it).

Dropout takes its keep masks from the caller (``draw``), as the rest of the
port's training takes its random numbers: the same masks give the same
forward on any device.  ``gelu`` is the tanh approximation, as JAX's
``jax.nn.gelu`` computes it by default.
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Optional

import numpy as np
import torch
from torch import nn

_ACTIVATIONS = {
    "relu": nn.ReLU,
    "gelu": lambda: nn.GELU(approximate="tanh"),
    "tanh": nn.Tanh,
    "identity": nn.Identity,
    "silu": nn.SiLU,
}


def _activation(name) -> nn.Module:
    # unknown names fall back to silu, as the reference's resolver does
    return _ACTIVATIONS.get((name or "silu").lower(), nn.SiLU)()


@dataclasses.dataclass(frozen=True)
class PerceptronConfig:
    in_dim: int
    out_dim: int
    hidden_dims: tuple = (128, 128)
    activation: str = "silu"
    final_activation: Optional[str] = None
    dropout: float = 0.0
    bias: bool = True
    random_ensembles: int = 1

    @classmethod
    def from_dict(cls, d: dict) -> "PerceptronConfig":
        fields = {f.name for f in dataclasses.fields(cls)}
        kw = {k: v for k, v in d.items() if k in fields}
        if kw.get("hidden_dims") is not None:
            hd = kw["hidden_dims"]
            kw["hidden_dims"] = tuple(hd) if isinstance(hd, (list, tuple)) else (hd,)
        return cls(**kw)

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["_class_name"] = "Perceptron"
        return d


class Perceptron(nn.Module):
    def __init__(self, config: PerceptronConfig, *, device, generator: torch.Generator):
        super().__init__()
        self.config = cfg = config
        self.dims = [cfg.in_dim, *cfg.hidden_dims, cfg.out_dim]
        nets = []
        for _k in range(cfg.random_ensembles):
            layers = []
            for i, (fan_in, fan_out) in enumerate(zip(self.dims[:-1], self.dims[1:])):
                lin = torch.nn.utils.skip_init(nn.Linear, fan_in, fan_out, bias=cfg.bias,
                                               device=device)
                with torch.no_grad():  # JAX's init: U(-1, 1) / sqrt(fan_in), zero bias
                    w = (torch.rand((fan_out, fan_in), generator=generator) * 2 - 1)
                    lin.weight.copy_(w / np.sqrt(fan_in))
                    if cfg.bias:
                        lin.bias.zero_()
                layers.append(lin)
                if i < len(self.dims) - 2:
                    layers.append(_activation(cfg.activation))
                    if cfg.dropout:
                        layers.append(nn.Dropout(cfg.dropout))
            if cfg.final_activation:
                layers.append(_activation(cfg.final_activation))
            nets.append(nn.Sequential(*layers))
        self.nets = nn.ModuleList(nets)

    def linear_positions(self) -> list:
        """The index of every Linear in each member's ``nn.Sequential``."""
        return [[i for i, m in enumerate(net) if isinstance(m, nn.Linear)] for net in self.nets]

    def draw(self, n: int, generator: torch.Generator) -> dict:
        """One training forward's random numbers for a batch of ``n``, drawn
        on the CPU: ``keep`` masks per member and hidden layer (with
        dropout) and ``ensemble_idx`` (with ensembles)."""
        cfg = self.config
        out = {}
        if cfg.dropout > 0:
            out["keep"] = [[torch.rand((n, d), generator=generator) < 1.0 - cfg.dropout
                            for d in self.dims[1:-1]] for _ in range(cfg.random_ensembles)]
        if cfg.random_ensembles > 1:
            out["ensemble_idx"] = torch.randint(0, cfg.random_ensembles, (n,),
                                                generator=generator)
        return out

    def _run(self, net, x, keep):
        hidden = 0
        for m in net:
            if isinstance(m, nn.Dropout):
                if keep is not None:  # after each hidden activation
                    mask = keep[hidden].to(x.device)
                    x = torch.where(mask, x / (1.0 - self.config.dropout), 0.0)
                hidden += 1
            else:
                x = m(x)
        return x

    def forward(self, x, ensemble_idx=None, draws: Optional[dict] = None):
        """Logits of x (N, in_dim).  ``draws`` (from ``draw``) turns on the
        training forward: dropout with its masks, its ensemble members;
        without them, or without an ``ensemble_idx``, member 0 answers."""
        draws = draws or {}
        keep = draws.get("keep")
        if self.config.random_ensembles == 1:
            return self._run(self.nets[0], x, keep[0] if keep else None)
        if ensemble_idx is None:
            ensemble_idx = draws.get("ensemble_idx")
        if ensemble_idx is None:
            ensemble_idx = torch.zeros((x.shape[0],), dtype=torch.long)
        outs = torch.stack([self._run(net, x, keep[k] if keep else None)
                            for k, net in enumerate(self.nets)])
        idx = torch.as_tensor(ensemble_idx, device=x.device).long()
        return outs[idx, torch.arange(x.shape[0], device=x.device)]

    def save_config(self, directory: str):
        os.makedirs(directory, exist_ok=True)
        with open(os.path.join(directory, "config.json"), "w") as f:
            json.dump(self.config.to_dict(), f, indent=2)
