"""Diffusion trainer, TrigFlow EDM (counterpart of
``terrain_diffusion_tpu/training/trainers/diffusion.py``).

The model trains in training mode, so every forward runs the plain path
(the kernels define no backward); ``evaluate`` runs the validation loss
under ``torch.no_grad()`` in eval mode.  ``evaluate_full`` (validation loss
plus KID) needs ``evaluation/``, which is not ported.
"""
from __future__ import annotations

import numpy as np
import torch

from terrain_diffusion_tpu_torch.training.diffusion_core import (DiffusionLossConfig, draws,
                                                                 diffusion_loss,
                                                                 make_optimizer,
                                                                 make_train_step)
from terrain_diffusion_tpu_torch.training.trainers.base import TrainerBase, ema_for


class DiffusionTrainer(TrainerBase):
    def __init__(self, config: dict, resolved: dict, device="cuda"):
        super().__init__(config, resolved, device)
        self.spec = resolved["model"]
        tr = config.get("training", {})
        sched = config.get("scheduler")
        self.loss_cfg = DiffusionLossConfig(
            sigma_data=float(sched.get("sigma_data", 0.5) if isinstance(sched, dict) else 0.5),
            P_mean=float(tr.get("P_mean", 0.0)),
            P_std=float(tr.get("P_std", 1.5)),
            scale_sigma=bool(tr.get("scale_sigma", False)),
            scaling_channels=tuple(tr.get("scaling_channels", ())),
            sigma_scale_eps=float(tr.get("sigma_scale_eps", 0.05)),
        )
        opt_kwargs = config.get("optimizer", {}).get("kwargs", {})
        self.optimizer = make_optimizer(
            betas=tuple(opt_kwargs.get("betas", (0.9, 0.99))),
            grad_clip=float(tr.get("gradient_clip_val", 10.0)))

        def loss_fn(model, batch, generator):
            return diffusion_loss(model, batch, draws(batch["image"], generator), self.loss_cfg)

        self._step = make_train_step(loss_fn, self.optimizer)

    def init_state(self, generator: torch.Generator, save_dir=None) -> dict:
        self.model = self.spec.build(self.device, generator).train()
        params = self.params()
        return {"opt_state": self.optimizer.init(params),
                "ema": ema_for(params, self.config, save_dir)}

    def prepare_batch(self, batch: dict) -> dict:
        out = {"image": self.to_device(batch["image"])}
        if batch.get("cond_img") is not None:
            out["cond_img"] = self.to_device(batch["cond_img"])
        if batch.get("cond_inputs"):
            out["cond_inputs"] = [self.to_device(c) for c in batch["cond_inputs"]]
        return out

    def train_step(self, state: dict, batch: dict, generator: torch.Generator,
                   counters: dict) -> dict:
        lr = self.lr_sched.get(counters["seen"])
        metrics = self._step(self.model, state["opt_state"], self.prepare_batch(batch),
                             generator, lr)
        return self._finish_step(state, metrics, np.shape(batch["image"])[0], counters, lr)

    @torch.no_grad()
    def evaluate(self, state: dict, batches, generator: torch.Generator) -> dict:
        """Mean validation loss over ``batches``, eval mode, one set of
        draws a batch from ``generator``."""
        self.model.eval()
        try:
            losses = []
            for batch in batches:
                b = self.prepare_batch(batch)
                loss, _ = diffusion_loss(self.model, b, draws(b["image"], generator),
                                         self.loss_cfg, training=False)
                losses.append(float(loss))
        finally:
            self.model.train()
        return {"val_loss": float(np.mean(losses))} if losses else {}

    def evaluate_full(self, state: dict, val_dataset, generator) -> dict:
        raise NotImplementedError("evaluate_full (validation loss + KID) needs evaluation/, "
                                  "which is not ported yet (ROADMAP.md section 1)")
