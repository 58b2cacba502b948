"""GAN trainer (counterpart of ``terrain_diffusion_tpu/training/trainers/gan.py``).

- Relativistic non-saturating losses: d = softplus(fake_pred - real_pred),
  g = softplus(real_pred (detached) - fake_pred).
- An R1-style gradient penalty on the combined real + fake discriminator
  input every ``r_interval`` steps, ``torch.autograd.grad(create_graph=True)``
  through the discriminator, with ``r_gamma`` warmed from
  ``r_gamma * r_warmup_factor`` down to ``r_gamma`` over ``burnin_steps``.
- A per-sample random crop of real and fake images to ``crop_size`` in the
  discriminator phase; the generator phase scores the uncropped fakes.
- Inject mode (``training.mode = 'inject'``): the generator sees
  TrigFlow-noised real images, t ~ atan(2 exp(8u - 3)) with a ``pct_fixed``
  share pinned to atan(160), ``pct_fixed`` warmed from ``warmup_pct_fixed``;
  the generator is an ``EDMUnet2D`` taking concat(mixed_real, z) with the
  per-sample t as its noise labels.
- Generator KL-to-unit-Gaussian (``kl_weight``) and range (``range_weight``)
  losses.
- Adam per network (clips 10 for the generator, 100 for the
  discriminator, ``disc_lr_mult``), the learning rate warmed by
  ``lr_warmup_factor`` and beta2 warmed from 1 - 10 (1 - b2) to b2 over
  ``burnin_steps``: b2 of the generator's betas, applied to both (as JAX
  and the reference do), per step (``ClippedAdam.update(b2=)``).  No
  forced weight re-normalization, as in JAX.
- FID with the shortest EMA's weights (``calculate_fid``) under no_grad.

The step's random numbers come from its generator (``draw``): the latent z,
inject mode's u, fixed-share u and image noise, and the crop offsets, so
the same draws (JAX's, in the tests) give the same step.  In data-parallel
training they are drawn for the global batch and cut to this rank's rows,
each optimizer averages its own gradients over the ranks, and the KL
term's batch mean and variance are the global batch's
(``distributed.batch_mean`` / ``batch_var``).  Every forward
autograd records runs the plain path; the discriminator phase's fakes and
the FID samples are generated under no_grad, inference forwards that on
the card take the kernels at maps of 128 x 128 pixels and up.  A checkpoint
carries the discriminator and its optimizer (``gan_state.pt``).
"""
from __future__ import annotations

import copy
import math
import os

import numpy as np
import torch
import torch.nn.functional as F

from terrain_diffusion_tpu_torch.parallel.distributed import batch_mean, batch_var
from terrain_diffusion_tpu_torch.parallel.mesh import take_rows
from terrain_diffusion_tpu_torch.training.diffusion_core import (gradients, make_optimizer,
                                                                 trained_tensors)
from terrain_diffusion_tpu_torch.training.trainers.base import (TrainerBase, ema_for,
                                                               load_opt_state)
from terrain_diffusion_tpu_torch.training.utils import to_cpu


def linear_warmup(start, end, step, total):
    if step >= total:
        return end
    return start + (end - start) * (step / total)


def random_crop(images, crop_size: int, offsets):
    """Per-sample square crops of NHWC ``images`` at ``offsets`` = (row
    starts, column starts), one per sample; the images as they are when
    they already have the crop's size."""
    _b, h, w, _c = images.shape
    if h == crop_size and w == crop_size:
        return images
    hs, ws = (o.tolist() for o in offsets)
    return torch.stack([img[i:i + crop_size, j:j + crop_size]
                        for img, i, j in zip(images, hs, ws)])


# FID processing constants (the reference's calculate_fid)
FID_MEAN = -2607.0
FID_STD = 2435.0
FID_MIN_ELEV = -10000.0
FID_MAX_ELEV = 9000.0


def process_for_fid(images: np.ndarray) -> np.ndarray:
    """Denormalized elevation mapped to [0, 255]: (B, H, W) -> (B, H, W, 1)
    float32, NHWC as every feature extractor takes it."""
    x = np.asarray(images, np.float32) * FID_STD + FID_MEAN
    x = np.clip(x, FID_MIN_ELEV, FID_MAX_ELEV)
    x = (x - FID_MIN_ELEV) * 255.0 / (FID_MAX_ELEV - FID_MIN_ELEV)
    return x[..., None]


class GANTrainer(TrainerBase):
    def __init__(self, config: dict, resolved: dict, device="cuda"):
        super().__init__(config, resolved, device)
        self.g_spec = resolved["model"]
        self.d_spec = resolved.get("discriminator") or resolved["model"]
        self.discriminator = None
        tr = config.get("training", {})
        self.latent_channels = int(tr.get("latent_channels", 1))
        self.crop_size = tr.get("crop_size")
        self.mode = tr.get("mode", "plain")
        self.r_gamma = float(tr.get("r_gamma", 0.0))
        self.r_interval = int(tr.get("r_interval", 16))
        self.r_warmup_factor = float(tr.get("r_warmup_factor", 10.0))
        self.burnin_steps = int(tr.get("burnin_steps", 0))
        self.kl_weight = float(tr.get("kl_weight", 0.0))
        self.range_weight = float(tr.get("range_weight", 1.0))
        self.pct_fixed = float(tr.get("pct_fixed", 0.5))
        self.warmup_pct_fixed = float(tr.get("warmup_pct_fixed", 0.5))
        self.lr_warmup_factor = float(tr.get("lr_warmup_factor", 1.0))
        self.disc_lr_mult = float(tr.get("disc_lr_mult", 1.0))
        g_betas = config.get("g_optimizer", {}).get("kwargs", {}).get("betas", (0.0, 0.99))
        d_betas = config.get("d_optimizer", {}).get("kwargs", {}).get("betas", (0.0, 0.99))
        # the beta2 warmup derives from the generator's betas and applies to
        # both optimizers
        self.final_beta2 = float(g_betas[1])
        self.initial_beta2 = 1.0 - 10.0 * (1.0 - self.final_beta2)
        self.opt_g = make_optimizer(betas=(float(g_betas[0]), self.final_beta2), grad_clip=10.0)
        self.opt_d = make_optimizer(betas=(float(d_betas[0]), self.final_beta2), grad_clip=100.0)

    def init_state(self, generator: torch.Generator, save_dir=None) -> dict:
        self.model = self.g_spec.build(self.device, generator).train()
        self.discriminator = self.d_spec.build(self.device, generator).train()
        g_params = self.params()
        return {"opt_state": self.opt_g.init(g_params),
                "d_opt_state": self.opt_d.init(trained_tensors(self.discriminator)),
                "ema": ema_for(g_params, self.config, save_dir)}

    # -- schedules (host side) ---------------------------------------------
    def _current(self, step: int):
        burnin = max(self.burnin_steps, 1)
        r_gamma = (linear_warmup(self.r_gamma * self.r_warmup_factor, self.r_gamma, step,
                                 self.burnin_steps)
                   if step < self.burnin_steps else self.r_gamma)
        b2 = (linear_warmup(self.initial_beta2, self.final_beta2, step, self.burnin_steps)
              if step < self.burnin_steps else self.final_beta2)
        pct_fixed = linear_warmup(self.warmup_pct_fixed, self.pct_fixed, step, burnin)
        lr_warm = linear_warmup(self.lr_warmup_factor, 1.0, step, burnin)
        return r_gamma, b2, pct_fixed, lr_warm

    # -- random numbers ------------------------------------------------------
    def _gen_draws(self, shape, generator):
        b, h, w, _c = shape
        out = {"z": torch.randn((b, h, w, self.latent_channels), generator=generator)}
        if self.mode == "inject":
            out.update(u=torch.rand((b,), generator=generator),
                       u_fixed=torch.rand((b,), generator=generator),
                       z_img=torch.randn(tuple(shape), generator=generator))
        return out

    def draw(self, shape, generator: torch.Generator) -> dict:
        """One step's random numbers for real images of ``shape``, on the
        CPU: the discriminator phase's generator draws (``d_gen``) and crop
        offsets (``crop_real``, ``crop_fake``), the generator phase's
        (``g_gen``)."""
        b, h, w, _c = shape
        out = {"d_gen": self._gen_draws(shape, generator)}
        cs = self.crop_size
        if cs is not None and (h, w) != (cs, cs):
            for name in ("crop_real", "crop_fake"):
                out[name] = (torch.randint(0, h - cs + 1, (b,), generator=generator),
                             torch.randint(0, w - cs + 1, (b,), generator=generator))
        out["g_gen"] = self._gen_draws(shape, generator)
        return out

    # -- the networks ---------------------------------------------------------
    def _generate(self, model, real, d: dict, pct_fixed: float):
        b = real.shape[0]
        z = d["z"].to(real.device)
        if self.mode != "inject":
            return model(z, torch.zeros((b,), device=real.device), [])
        t = torch.atan(2.0 * torch.exp(8.0 * d["u"] - 3.0))
        t = torch.where(d["u_fixed"] < pct_fixed, torch.tensor(math.atan(160.0)), t)
        t = t.to(real.device)
        tt = t[:, None, None, None]
        mixed = torch.cos(tt) * real + torch.sin(tt) * d["z_img"].to(real.device)
        return model(torch.cat([mixed, z], dim=-1), t, [])

    def _disc_pred(self, images):
        out = self.discriminator(images, torch.zeros((images.shape[0],), device=images.device),
                                 [])
        return out.mean(dim=(1, 2, 3))

    def _crop(self, images, offsets):
        return images if offsets is None else random_crop(images, int(self.crop_size), offsets)

    # -- the step -----------------------------------------------------------
    def step(self, state: dict, real, d: dict, lr: float, b2: float, pct_fixed: float,
             r_gamma: float, with_r1: bool, rows=None) -> dict:
        """The discriminator update, then the generator update against the
        updated discriminator, on the draws ``d``; returns 0-d tensors.
        ``rows``: the rows of the global batch ``real`` holds."""
        g_params = self.params()
        d_params = trained_tensors(self.discriminator)
        b = real.shape[0]

        with torch.no_grad():
            fake = self._generate(self.model, real, d["d_gen"], pct_fixed)
        all_images = torch.cat([self._crop(real, d.get("crop_real")),
                                self._crop(fake, d.get("crop_fake"))])
        if with_r1:
            all_images.requires_grad_(True)
        pred = self._disc_pred(all_images)
        real_pred, fake_pred = pred[:b], pred[b:]
        d_loss = F.softplus(fake_pred - real_pred).mean()
        if with_r1:
            (grad_in,) = torch.autograd.grad(pred.sum(), all_images, create_graph=True)
            r_reg = 0.5 * torch.square(grad_in).reshape(2 * b, -1).sum(1).mean()
            total = d_loss + r_gamma * r_reg
        else:
            r_reg = torch.zeros((), device=real.device)
            total = d_loss
        d_norm = self._update(self.opt_d, d_params, total, state["d_opt_state"],
                              lr * self.disc_lr_mult, b2)

        fake = self._generate(self.model, real, d["g_gen"], pct_fixed)
        fake_pred = self._disc_pred(fake)
        g_loss = F.softplus(real_pred.detach() - fake_pred).mean()
        mean = batch_mean(fake, (0, 1, 2), rows)
        # eps inside the sqrt: a zero-init out gain makes the fakes constant,
        # where d(std)/dx is NaN
        std = torch.sqrt(batch_var(fake, (0, 1, 2), rows) + 1e-8)
        kl = (torch.log(1.0 / std) + (std ** 2 + mean ** 2) / 2.0 - 0.5).mean()
        range_loss = (F.relu(-2.0 - fake) ** 2 + F.relu(fake - 3.2) ** 2).mean()
        total = g_loss + self.kl_weight * kl + self.range_weight * range_loss
        g_norm = self._update(self.opt_g, g_params, total, state["opt_state"], lr, b2)
        return {"d_loss": d_loss.detach(), "g_loss": g_loss.detach(), "kl_loss": kl.detach(),
                "range_loss": range_loss.detach(), "r_loss": r_reg.detach(),
                "d_grad_norm": d_norm, "g_grad_norm": g_norm}

    @staticmethod
    def _update(opt, params: dict, loss, opt_state, lr, b2):
        return opt.update(params, gradients(params, loss), opt_state, lr, b2=b2)

    def train_step(self, state: dict, batch: dict, generator: torch.Generator,
                   counters: dict) -> dict:
        step_i = counters["step"]
        r_gamma, b2, pct_fixed, lr_warm = self._current(step_i)
        lr = self.lr_sched.get(counters["seen"]) * lr_warm
        with_r1 = self.r_gamma > 0 and step_i % self.r_interval == 0
        local, rows = self.shard(batch)
        real = self.to_device(local["image"])
        if rows is None:
            d = self.draw(real.shape, generator)
        else:
            d = take_rows(self.draw((rows.total, *real.shape[1:]), generator), rows)
        metrics = self.step(state, real, d, lr, b2, pct_fixed, r_gamma, with_r1, rows)
        return self._finish_step(state, metrics, np.shape(batch["image"])[0], counters, lr)

    # -- FID evaluation ------------------------------------------------------
    @torch.no_grad()
    def calculate_fid(self, weights, val_batches, generator: torch.Generator,
                      feature_fn="terrain") -> float:
        """FID between generated and validation elevations, both
        denormalized, clamped and scaled as ``process_for_fid``; the
        generator runs with ``weights`` (a state dict, or None for its
        own) in eval mode, inject mode at t = atan(160)."""
        from terrain_diffusion_tpu_torch.evaluation.metrics import (compute_fid,
                                                                    resolve_feature_fn)

        model = copy.deepcopy(self.model).eval().requires_grad_(False)
        if weights is not None:
            model.load_state_dict(weights, strict=False)
        reals, fakes = [], []
        for batch in val_batches:
            real = self.to_device(batch["image"])
            d = {"z": torch.randn((*real.shape[:3], self.latent_channels), generator=generator)}
            if self.mode == "inject":  # every sample at the fixed t
                d.update(u=torch.zeros((real.shape[0],)), u_fixed=torch.zeros((real.shape[0],)),
                         z_img=torch.randn(tuple(real.shape), generator=generator))
            fake = self._generate(model, real, d, pct_fixed=1.0)
            reals.append(process_for_fid(real[..., 0].cpu().numpy()))
            fakes.append(process_for_fid(fake[..., 0].cpu().numpy()))
        return compute_fid(np.concatenate(reals), np.concatenate(fakes),
                           feature_fn=resolve_feature_fn(feature_fn), device=self.device)

    def evaluate(self, state: dict, batches, generator: torch.Generator) -> dict:
        weights = state["ema"].shortest() if state.get("ema") and state["ema"].emas else None
        feature_fn = self.config.get("evaluation", {}).get("feature_fn", "terrain")
        return {"val/fid": self.calculate_fid(weights, batches, generator, feature_fn)}

    # -- checkpointing: the adversary survives a resume ----------------------
    def save_checkpoint(self, state: dict, path: str, counters: dict):
        super().save_checkpoint(state, path, counters)
        torch.save({"d_state": to_cpu(self.discriminator.state_dict()),
                    "d_opt_state": to_cpu(state["d_opt_state"])},
                   os.path.join(path, "gan_state.pt"))

    def load_checkpoint(self, state: dict, path: str) -> dict:
        gan_path = os.path.join(path, "gan_state.pt")
        if not os.path.exists(gan_path):
            raise FileNotFoundError(
                f"{gan_path} missing: a GAN checkpoint without the discriminator would "
                "resume a trained generator against a fresh adversary")
        counters = super().load_checkpoint(state, path)
        blob = torch.load(gan_path, map_location="cpu")
        self.discriminator.load_state_dict(blob["d_state"])
        load_opt_state(state["d_opt_state"], blob["d_opt_state"])
        return counters
