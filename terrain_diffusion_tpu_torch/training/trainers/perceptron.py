"""Perceptron (biome MLP) trainer (counterpart of
``terrain_diffusion_tpu/training/trainers/perceptron.py``): cross-entropy of
climate 4-vectors against Koppen classes, Adam (optax's defaults: betas
(0.9, 0.999)) with global-norm clipping at ``gradient_clip_val``, PostHoc
EMA.  The dropout masks and ensemble members come from the step's
generator (``Perceptron.draw``), for the global batch, cut to this rank's
rows in data-parallel training."""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from terrain_diffusion_tpu_torch.parallel.mesh import take_rows
from terrain_diffusion_tpu_torch.training.diffusion_core import make_optimizer, make_train_step
from terrain_diffusion_tpu_torch.training.trainers.base import TrainerBase, ema_for


def perceptron_loss(model, batch: dict, draws: dict):
    """Mean softmax cross-entropy of the logits against integer labels, and
    the accuracy."""
    logits = model(batch["image"], draws=draws)
    labels = batch["label"].long()
    loss = F.cross_entropy(logits, labels)
    acc = (logits.argmax(-1) == labels).float().mean()
    return loss, {"acc": acc.detach()}


class PerceptronTrainer(TrainerBase):
    def __init__(self, config: dict, resolved: dict, device="cuda"):
        super().__init__(config, resolved, device)
        self.spec = resolved["model"]
        tr = config.get("training", {})
        self.optimizer = make_optimizer(betas=(0.9, 0.999),
                                        grad_clip=float(tr.get("gradient_clip_val", 10.0)))

        def loss_fn(model, batch, generator):
            rows = batch.get("_rows")
            if rows is None:
                return perceptron_loss(model, batch, model.draw(batch["image"].shape[0],
                                                                generator))
            return perceptron_loss(model, batch, take_rows(model.draw(rows.total, generator),
                                                           rows))

        self._step = make_train_step(loss_fn, self.optimizer, renorm_weights=False)

    def init_state(self, generator: torch.Generator, save_dir=None) -> dict:
        self.model = self.spec.build(self.device, generator).train()
        params = self.params()
        return {"opt_state": self.optimizer.init(params),
                "ema": ema_for(params, self.config, save_dir)}

    def train_step(self, state: dict, batch: dict, generator: torch.Generator,
                   counters: dict) -> dict:
        lr = self.lr_sched.get(counters["seen"])
        # collate leaves numpy integer labels a list: one array, so it shards
        local, rows = self.shard({**batch, "label": np.asarray(batch["label"])})
        b = {"image": self.to_device(np.asarray(local["image"], np.float32)),
             "label": self.to_device(local["label"]), "_rows": rows}
        metrics = self._step(self.model, state["opt_state"], b, generator, lr)
        return self._finish_step(state, metrics, np.shape(batch["image"])[0], counters, lr)
