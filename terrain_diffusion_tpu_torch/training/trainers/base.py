"""Trainer base (counterpart of ``terrain_diffusion_tpu/training/trainers/base.py``).

A trainer owns the model, the loss, the optimizer, the EMA and the
(de)serialization of its training state.  The train loop (``train.py``)
drives ``train_step`` with host-prefetched numpy batches.  A checkpoint
directory holds ``saved_model/`` in the reference format
(``nn/torch_compat.save_model``) and ``train_state.pt``: the optimizer
state, the EMA state and the counters.

Data-parallel training: ``train.py`` sets ``mesh`` to the process group's
mesh, and ``train_step`` gets the global batch; ``shard`` gives this
rank's rows of it (``parallel.shard_batch``) and their ``Rows``, at which
each trainer cuts the step's draws, made for the global batch.  The
``seen`` counter counts the global batch.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from terrain_diffusion_tpu_torch.nn import torch_compat
from terrain_diffusion_tpu_torch.parallel.mesh import local_rows, shard_batch
from terrain_diffusion_tpu_torch.training.diffusion_core import trained_tensors
from terrain_diffusion_tpu_torch.training.phema import PostHocEMA
from terrain_diffusion_tpu_torch.training.utils import to_cpu


class TrainerBase:
    model = None  # set by subclass: the trained nn.Module
    mesh = None  # a process group's mesh in data-parallel training

    def __init__(self, config: dict, resolved: dict, device):
        self.config = config
        self.resolved = resolved
        self.device = torch.device(device)
        self.lr_sched = resolved["lr_sched"]

    def init_state(self, generator: torch.Generator, save_dir=None) -> dict:
        raise NotImplementedError

    def train_step(self, state: dict, batch: dict, generator: torch.Generator,
                   counters: dict) -> dict:
        raise NotImplementedError

    def shard(self, batch: dict):
        """(this rank's rows of the global ``batch``, their ``Rows``, or None
        outside data-parallel training)."""
        if self.mesh is None:
            return batch, None
        return shard_batch(self.mesh, batch), local_rows(self.mesh,
                                                         np.shape(batch["image"])[0])

    def to_device(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a)).to(self.device)

    def params(self) -> dict:
        return trained_tensors(self.model)

    def _finish_step(self, state: dict, metrics: dict, n_images: int, counters: dict,
                     lr: float) -> dict:
        counters["seen"] += int(n_images)
        counters["step"] += 1
        if state.get("ema") is not None:
            state["ema"].update(self.params(), counters["step"])
        metrics = {k: float(v) for k, v in metrics.items()}
        metrics["lr"] = lr
        return metrics

    # -- checkpointing --------------------------------------------------
    def save_checkpoint(self, state: dict, path: str, counters: dict):
        os.makedirs(path, exist_ok=True)
        torch_compat.save_model(self.model, os.path.join(path, "saved_model"))
        torch.save({"opt_state": to_cpu(state["opt_state"]),
                    "ema": state["ema"].state_dict() if state.get("ema") else None,
                    "counters": dict(counters)},
                   os.path.join(path, "train_state.pt"))

    def load_checkpoint(self, state: dict, path: str) -> dict:
        from safetensors.torch import load_file

        weights = load_file(os.path.join(path, "saved_model", "model.safetensors"))
        self.model.load_state_dict({k: v.to(self.device) for k, v in weights.items()})
        blob = torch.load(os.path.join(path, "train_state.pt"), map_location="cpu")
        load_opt_state(state["opt_state"], blob["opt_state"])
        if blob.get("ema") and state.get("ema"):
            state["ema"].load_state_dict(blob["ema"])
        return blob["counters"]


def load_opt_state(opt: dict, saved: dict):
    """Copy a saved ``ClippedAdam`` state into a live one, in place."""
    opt["count"] = int(saved["count"])
    for moment in ("mu", "nu"):
        for k, v in opt[moment].items():
            v.copy_(saved[moment][k])


def ema_for(params: dict, config: dict, save_dir: str | None) -> PostHocEMA:
    ema_cfg = config.get("ema", {})
    folder = os.path.join(save_dir, "phema") if save_dir else None
    return PostHocEMA(params, sigma_rels=tuple(ema_cfg.get("sigma_rels", [0.05, 0.1])),
                      folder=folder, update_every=int(ema_cfg.get("update_every", 1)))
