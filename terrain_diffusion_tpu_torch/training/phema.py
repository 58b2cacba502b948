"""Post-hoc EMA (Karras et al. 2024, "Analyzing and Improving the Training
Dynamics of Diffusion Models", arXiv 2312.02696 App. B), on state dicts
(counterpart of ``terrain_diffusion_tpu/training/phema.py``).

A few power-function EMA profiles (sigma_rels, e.g. [0.05, 0.1]) are kept
online and snapshotted now and then (``{sigma_rel}.{step}.pt``); after
training, the EMA profile of any target sigma_rel is synthesized by
least-squares mixing of the stored snapshots.
"""
from __future__ import annotations

import os
from typing import Sequence

import numpy as np
import torch


def sigma_rel_to_gamma(sigma_rel: float) -> float:
    """Invert sigma_rel = sqrt((gamma+1)/((gamma+2)^2 (gamma+3))) (paper eq. 31)."""
    t = sigma_rel**-2
    # the real root of gamma^3 + 7g^2 + (16 - t) g + (12 - t) = 0
    roots = np.roots([1.0, 7.0, 16.0 - t, 12.0 - t])
    real = roots[np.isreal(roots)].real
    return float(np.max(real))


def _p_dot_p(t_a, gamma_a, t_b, gamma_b):
    """Inner product of two power-function EMA profiles (paper eq. 36)."""
    t_ratio = t_a / t_b
    t_exp = np.where(t_a < t_b, gamma_b, -gamma_a)
    t_max = np.maximum(t_a, t_b)
    num = (gamma_a + 1) * (gamma_b + 1) * t_ratio**t_exp
    den = (gamma_a + gamma_b + 1) * t_max
    return num / den


def solve_weights(t_i: np.ndarray, gamma_i: np.ndarray, t_r: float,
                  gamma_r: float) -> np.ndarray:
    """Least-squares snapshot weights reconstructing profile (t_r, gamma_r)."""
    rv = lambda x: np.float64(x).reshape(-1, 1)  # noqa: E731
    cv = lambda x: np.float64(x).reshape(1, -1)  # noqa: E731
    A = _p_dot_p(rv(t_i), rv(gamma_i), cv(t_i), cv(gamma_i))
    b = _p_dot_p(rv(t_i), rv(gamma_i), cv([t_r]), cv([gamma_r]))
    return np.linalg.solve(A, b).reshape(-1)


def _clone(state: dict) -> dict:
    return {k: v.detach().clone() for k, v in state.items()}


class PostHocEMA:
    """Online power-EMA tracker with periodic snapshots, over a state dict
    of float tensors (the model's parameters):

        ema = PostHocEMA(dict(model.named_parameters()), folder="ckpt/phema")
        ema.update(dict(model.named_parameters()), step)   # every step
        ema.checkpoint(step)                               # now and then
        state = ema.synthesize(sigma_rel=0.2)              # after training
    """

    def __init__(self, params: dict, sigma_rels: Sequence[float] = (0.05, 0.1),
                 folder: str | None = None, update_every: int = 1):
        self.sigma_rels = tuple(float(s) for s in sigma_rels)
        self.gammas = tuple(sigma_rel_to_gamma(s) for s in self.sigma_rels)
        self.emas = [_clone(params) for _ in self.sigma_rels]
        self.folder = folder
        self.update_every = update_every
        if folder:
            os.makedirs(folder, exist_ok=True)

    @torch.no_grad()
    def update(self, params: dict, step: int):
        if step % self.update_every != 0:
            return
        t = max(step, 1)
        for ema, gamma in zip(self.emas, self.gammas):
            beta = (1 - 1 / t) ** (gamma + 1)
            for k, e in ema.items():
                e.copy_(e * beta + params[k] * (1 - beta))

    def checkpoint(self, step: int):
        if not self.folder:
            raise ValueError("no snapshot folder configured")
        for sr, ema in zip(self.sigma_rels, self.emas):
            torch.save({k: v.cpu() for k, v in ema.items()},
                       os.path.join(self.folder, f"{sr}.{step}.pt"))

    def shortest(self) -> dict:
        """The lowest-sigma_rel (least smoothed) EMA state: config order of
        sigma_rels is kept in self.emas, so index 0 need not be it."""
        i = min(range(len(self.sigma_rels)), key=lambda k: self.sigma_rels[k])
        return self.emas[i]

    # -- the live state (train resume) ----------------------------------
    def state_dict(self) -> dict:
        return {"sigma_rels": self.sigma_rels,
                "emas": [{k: v.cpu() for k, v in e.items()} for e in self.emas]}

    def load_state_dict(self, state: dict):
        if tuple(state["sigma_rels"]) != self.sigma_rels:
            raise ValueError(f"EMA state of sigma_rels {state['sigma_rels']}, this "
                             f"tracker has {self.sigma_rels}")
        for ema, saved in zip(self.emas, state["emas"]):
            for k, v in ema.items():
                v.copy_(saved[k])

    # -- post-hoc synthesis ---------------------------------------------
    @staticmethod
    def list_snapshots(folder: str):
        out = []
        for name in sorted(os.listdir(folder)):
            if name.endswith(".pt"):
                sr, step = name[:-3].rsplit(".", 1)
                out.append((float(sr), int(step), os.path.join(folder, name)))
        return out

    @classmethod
    def synthesize_from_folder(cls, folder: str, sigma_rel: float,
                               step: int | None = None) -> dict:
        """Least-squares EMA synthesis from the stored snapshots (CPU
        tensors of the snapshots' type)."""
        snaps = cls.list_snapshots(folder)
        if step is not None:
            snaps = [s for s in snaps if s[1] <= step]
        if not snaps:
            raise ValueError(f"no snapshots in {folder}")
        t_max = max(s[1] for s in snaps)
        t_i = np.array([max(s[1], 1) for s in snaps], dtype=np.float64)
        gamma_i = np.array([sigma_rel_to_gamma(s[0]) for s in snaps])
        gamma_r = sigma_rel_to_gamma(sigma_rel)
        w = solve_weights(t_i, gamma_i, float(step or t_max), gamma_r)
        out = None  # summed in float64, as numpy sums the JAX snapshots
        for weight, (_sr, _st, path) in zip(w, snaps):
            snap = torch.load(path, map_location="cpu")
            if out is None:
                out = {k: v.double() * float(weight) for k, v in snap.items()}
            else:
                out = {k: out[k] + snap[k].double() * float(weight) for k in out}
        return {k: v.to(snap[k].dtype) for k, v in out.items()}

    def synthesize(self, sigma_rel: float, step: int | None = None) -> dict:
        return self.synthesize_from_folder(self.folder, sigma_rel, step)
