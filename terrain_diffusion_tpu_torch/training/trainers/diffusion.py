"""Diffusion trainer, TrigFlow EDM (counterpart of
``terrain_diffusion_tpu/training/trainers/diffusion.py``).

The model trains in training mode, so every forward runs the plain path
(the kernels define no backward); ``evaluate`` runs the validation loss
under ``torch.no_grad()`` in eval mode.  ``evaluate_full`` adds KID with
the shortest EMA's weights: a sampling run of inference forwards, which on
the card take the kernels (``trainers/eval_kid.py``).
"""
from __future__ import annotations

import copy

import numpy as np
import torch

from terrain_diffusion_tpu_torch.training.diffusion_core import (DiffusionLossConfig, draws,
                                                                 diffusion_loss,
                                                                 key_from_generator,
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
            return diffusion_loss(model, batch,
                                  draws(batch["image"], generator, batch.get("_rows")),
                                  self.loss_cfg)

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
        local, rows = self.shard(batch)
        metrics = self._step(self.model, state["opt_state"],
                             {**self.prepare_batch(local), "_rows": rows}, generator, lr)
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

    def evaluate_full(self, state: dict, val_dataset, generator: torch.Generator,
                      key=None) -> dict:
        """Validation loss plus KID with the EMA weights (reference
        ``diffusion.py:355-427``), sampling on validation conditioning and,
        with ``[evaluation] kid_autoencoder_path``, decoding the latents to
        terrain through that decoder.  ``key`` (a threefry key) drives the
        sampling as JAX's key does; by default it is drawn from
        ``generator``, which also draws the validation loss's noise."""
        from terrain_diffusion_tpu_torch.nn import torch_compat
        from terrain_diffusion_tpu_torch.ops.noise_field import split
        from terrain_diffusion_tpu_torch.training.datasets import collate
        from terrain_diffusion_tpu_torch.training.trainers.eval_kid import evaluate_kid

        ev = self.config.get("evaluation", {})
        n_val = int(ev.get("validation_steps", 64))
        bs = int(ev.get("kid_batch_size", 8))
        batches = [collate([val_dataset[i * bs + j] for j in range(bs)])
                   for i in range(max(n_val // bs, 1))]
        if key is None:
            key = key_from_generator(generator)
        _key, _k1, k2 = split(key, 3)
        out = self.evaluate(state, batches, generator)
        if not ev.get("kid_enabled", False):
            return out
        model = copy.deepcopy(self.model).eval().requires_grad_(False)
        if state.get("ema") is not None and state["ema"].emas:
            model.load_state_dict({**model.state_dict(), **state["ema"].shortest()})
        decoder = None
        if ev.get("kid_autoencoder_path"):
            decoder = torch_compat.load_model(ev["kid_autoencoder_path"], device=self.device)
        kid = evaluate_kid(model, val_dataset, k2, mode=ev.get("mode", "base"),
                           n_images=int(ev.get("kid_n_images", 128)), batch=bs,
                           steps=int(ev.get("kid_scheduler_steps", 12)), decoder=decoder)
        out.update({f"val_{k}": v for k, v in kid.items()})
        return out
