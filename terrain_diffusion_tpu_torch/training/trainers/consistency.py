"""Consistency (sCM/TrigFlow) distillation trainer (counterpart of
``terrain_diffusion_tpu/training/trainers/consistency.py``).

The teacher (``[model] main_path``) and the optional AutoGuidance guide
(``guide_path``) are loaded with ``torch_compat.load_model`` and run in eval
mode under ``torch.no_grad()``: inference forwards, which on the card take
the fused-block and 3x3-conv kernels on maps of 128 x 128 pixels and up.
The student starts from the teacher's weights with ``logvar_linear``
re-randomized, and runs in training mode inside the JVP (the plain path).
"""
from __future__ import annotations

import copy

import numpy as np
import torch

from terrain_diffusion_tpu_torch.nn import torch_compat
from terrain_diffusion_tpu_torch.training.diffusion_core import (ConsistencyLossConfig,
                                                                 consistency_loss, draws,
                                                                 make_optimizer,
                                                                 make_train_step)
from terrain_diffusion_tpu_torch.training.trainers.base import TrainerBase, ema_for


def _frozen(model):
    model.eval()
    for p in model.parameters():
        p.requires_grad_(False)
    return model


class ConsistencyTrainer(TrainerBase):
    def __init__(self, config: dict, resolved: dict, device="cuda"):
        super().__init__(config, resolved, device)
        tr = config.get("training", {})
        model_cfg = config.get("model", {})
        self.main_path = model_cfg.get("main_path")
        self.guide_path = model_cfg.get("guide_path")
        self.spec = resolved.get("model")
        self.teacher = self.guide = None
        if self.guide_path:
            self.guide = _frozen(torch_compat.load_model(self.guide_path, device=self.device))
        self.loss_cfg = ConsistencyLossConfig(
            sigma_data=float(tr.get("sigma_data", 0.5)),
            P_mean=float(tr.get("P_mean", -1.0)),
            P_std=float(tr.get("P_std", 1.4)),
            guidance_scale=float(model_cfg.get("guidance_scale", 1.0)),
            warmup_steps=int(tr.get("warmup_steps", 10000)),
            loss_groups=tuple(tr["loss_groups"]) if tr.get("loss_groups") else None,
            use_logvar=bool(tr.get("use_logvar", True)),
            const_c=float(tr.get("const_c", 0.1)),
        )
        opt_kwargs = config.get("optimizer", {}).get("kwargs", {})
        self.optimizer = make_optimizer(
            betas=tuple(opt_kwargs.get("betas", (0.9, 0.99))),
            grad_clip=float(tr.get("gradient_clip_val", 100.0)))
        self._step = make_train_step(self._loss, self.optimizer)

    def _loss(self, model, batch, generator):
        return consistency_loss(model, self.teacher, batch,
                                draws(batch["image"], generator, batch.get("_rows")),
                                self.loss_cfg, batch["_step"], guide_fn=self.guide)

    def init_state(self, generator: torch.Generator, save_dir=None) -> dict:
        if self.main_path:
            self.teacher = _frozen(torch_compat.load_model(self.main_path, device=self.device))
        else:  # no teacher checkpoint: the teacher is the model's own init
            self.teacher = _frozen(self.spec.build(self.device, generator))
        self.model = copy.deepcopy(self.teacher).train()  # trained_tensors turn grads on
        # the reference re-randomizes the logvar head at distillation start
        w = self.model.logvar_linear.weight
        with torch.no_grad():
            w.copy_(torch.randn(tuple(w.shape), generator=generator).to(w.device))
        params = self.params()
        return {"opt_state": self.optimizer.init(params),
                "ema": ema_for(params, self.config, save_dir)}

    def prepare_batch(self, batch: dict, step: int) -> dict:
        out = {"image": self.to_device(batch["image"]), "_step": int(step)}
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
                             {**self.prepare_batch(local, counters["step"]), "_rows": rows},
                             generator, lr)
        return self._finish_step(state, metrics, np.shape(batch["image"])[0], counters, lr)
