"""Autoencoder (VAE) trainer (counterpart of
``terrain_diffusion_tpu/training/trainers/autoencoder.py``).

Loss: MAE + KL + a perceptual term (``diffusion_core.autoencoder_loss``).
``training.perceptual`` picks the term: ``"grad"`` (the default, a
multi-scale gradient-similarity surrogate) or ``"lpips"`` (LPIPS-Alex,
``nn/lpips.py``, from ``training.lpips_weights`` and optionally
``training.lpips_lin_weights``); ``training.use_perceptual = false`` turns
it off.  Adam with betas from ``[optimizer] kwargs`` and global-norm
clipping at ``gradient_clip_val``, forced weight re-normalization after
each update, PostHoc EMA.  The posterior sample of a step comes from a
threefry key seeded from the step's generator (``key_from_generator``).

Training forwards run the plain path (the kernels define no backward);
``evaluate`` runs the same loss under ``torch.no_grad()`` in eval mode,
where on the card the blocks of at least 128 x 128 pixels take the
fused-block kernel and the encoder's in conv the 3x3-conv kernel.
"""
from __future__ import annotations

import numpy as np
import torch

from terrain_diffusion_tpu_torch.training.diffusion_core import (autoencoder_loss,
                                                                 key_from_generator,
                                                                 make_optimizer,
                                                                 make_train_step)
from terrain_diffusion_tpu_torch.training.trainers.base import TrainerBase, ema_for


def multiscale_gradient_loss(recon, target, scales=(1, 2, 4)):
    """Cheap perceptual surrogate: L1 on image gradients at several scales
    (NHWC)."""
    loss = 0.0
    for s in scales:
        r = recon[:, ::s, ::s, :]
        t = target[:, ::s, ::s, :]
        loss = loss + torch.abs(torch.diff(r, dim=1) - torch.diff(t, dim=1)).mean()
        loss = loss + torch.abs(torch.diff(r, dim=2) - torch.diff(t, dim=2)).mean()
    return loss / len(scales)


def perceptual_for(tr: dict, device):
    """The ``[training]`` section's perceptual term, or None."""
    if not bool(tr.get("use_perceptual", True)):
        return None
    kind = tr.get("perceptual", "grad")
    if kind == "grad":
        return multiscale_gradient_loss
    if kind == "lpips":
        from terrain_diffusion_tpu_torch.nn import lpips

        weights = tr.get("lpips_weights")
        if not weights:
            raise ValueError("training.perceptual='lpips' needs training.lpips_weights "
                             "(AlexNet backbone .pth/.safetensors; optional separate "
                             "training.lpips_lin_weights for the lpips linear heads)")
        net = lpips.load_torch_checkpoint(weights, tr.get("lpips_lin_weights"), device=device)
        return lpips.make_perceptual_fn(net)
    raise ValueError(f"unknown training.perceptual {kind!r}")


class AutoencoderTrainer(TrainerBase):
    def __init__(self, config: dict, resolved: dict, device="cuda"):
        super().__init__(config, resolved, device)
        self.spec = resolved["model"]
        tr = config.get("training", {})
        self.kl_weight = float(tr.get("kl_weight", 1e-5))
        self.perceptual_weight = float(tr.get("perceptual_weight", 1.0))
        self.perceptual_fn = perceptual_for(tr, self.device)
        opt_kwargs = config.get("optimizer", {}).get("kwargs", {})
        self.optimizer = make_optimizer(
            betas=tuple(opt_kwargs.get("betas", (0.9, 0.99))),
            grad_clip=float(tr.get("gradient_clip_val", 10.0)))
        self._step = make_train_step(
            lambda model, batch, generator: self._loss(
                model, batch, key_from_generator(generator), batch.get("_rows")),
            self.optimizer)

    def _loss(self, model, batch, key, rows=None):
        return autoencoder_loss(model, batch, key, kl_weight=self.kl_weight,
                                perceptual_fn=self.perceptual_fn,
                                perceptual_weight=self.perceptual_weight, rows=rows)

    def init_state(self, generator: torch.Generator, save_dir=None) -> dict:
        self.model = self.spec.build(self.device, generator).train()
        params = self.params()
        return {"opt_state": self.optimizer.init(params),
                "ema": ema_for(params, self.config, save_dir)}

    def train_step(self, state: dict, batch: dict, generator: torch.Generator,
                   counters: dict) -> dict:
        lr = self.lr_sched.get(counters["seen"])
        local, rows = self.shard(batch)
        metrics = self._step(self.model, state["opt_state"],
                             {"image": self.to_device(local["image"]), "_rows": rows},
                             generator, lr)
        return self._finish_step(state, metrics, np.shape(batch["image"])[0], counters, lr)

    @torch.no_grad()
    def evaluate(self, state: dict, batches, generator: torch.Generator) -> dict:
        """Mean validation loss and terms over ``batches``, eval mode, one
        posterior key a batch from ``generator``."""
        self.model.eval()
        out = []
        try:
            for batch in batches:
                loss, aux = self._loss(self.model, {"image": self.to_device(batch["image"])},
                                       key_from_generator(generator))
                out.append({"val_loss": float(loss),
                            **{f"val_{k}": float(v) for k, v in aux.items()}})
        finally:
            self.model.train()
        return {k: float(np.mean([o[k] for o in out])) for k in out[0]} if out else {}
