"""TrigFlow/EDM training losses and the train step (counterpart of
``terrain_diffusion_tpu/training/diffusion_core.py``).

- diffusion: sigma ~ LogNormal(P_mean, P_std), optional per-sample sigma
  scaling, t = atan(sigma/sigma_data), x_t = cos t * x + sin t * noise,
  v-target, logvar-weighted loss;
- consistency (sCM/TrigFlow distillation): teacher velocity (+ optional
  AutoGuidance mix), the JVP of the student (``torch.func.jvp``, where JAX
  uses ``jax.jvp``), tangent-normalized target with warmup ratio r, adaptive
  logvar weighting;
- autoencoder: MAE + KL (+ an optional perceptual term), the posterior
  sample drawn from a threefry key as JAX draws it.

Each loss is split in two: ``draws(images, generator)`` draws the step's
random numbers from a CPU ``torch.Generator`` (standard normals for sigma
and the noise, and a dropout seed), and the loss itself is a function of
the model, the batch and those draws, so the same draws (JAX's own, in the
tests) give the same loss on any device.

``make_optimizer`` is optax's chain of ``clip_by_global_norm``,
``scale_by_adam`` and the learning rate, written out (``ClippedAdam``);
``make_train_step`` adds the forced weight re-normalization after each
update (EDM2).  Batches are NHWC, as in JAX.

Data-parallel training (``parallel/distributed.py``): each rank holds
``rows`` of the global batch (``parallel.mesh.Rows``).  Every draw is made
at the global batch's shape and cut to those rows, dropout masks too, so
the ranks together draw what one process draws; the train step averages
the gradients over the ranks before the update, and the clip then acts on
the global gradient's norm, as JAX's does.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from terrain_diffusion_tpu_torch.nn.layers import normalize_weights_
from terrain_diffusion_tpu_torch.nn.torch_compat import name_map
from terrain_diffusion_tpu_torch.parallel.distributed import all_reduce_mean_


@dataclasses.dataclass(frozen=True)
class DiffusionLossConfig:
    sigma_data: float = 0.5
    P_mean: float = 0.0
    P_std: float = 1.5
    scale_sigma: bool = False
    scaling_channels: tuple = ()
    sigma_scale_eps: float = 0.05


def draws(images: torch.Tensor, generator: torch.Generator, rows=None) -> dict:
    """One step's random numbers, drawn on the CPU from ``generator`` and
    moved to the images' device: ``sigma_normal`` (N, 1, 1, 1) and ``noise``
    (the images' shape) standard normals, and ``dropout_seed`` (an int)
    that seeds the student's dropout generator (JAX: k_sigma, k_noise,
    k_drop of ``jax.random.split(key, 3)``).  With ``rows`` the images
    are those rows of a global batch: the normals are drawn for the global
    batch and cut to them, and ``rows`` rides along for the dropout."""
    n = images.shape[0] if rows is None else rows.total
    sigma_normal = torch.randn((n, 1, 1, 1), generator=generator)
    noise = torch.randn((n, *images.shape[1:]), generator=generator)
    seed = int(torch.randint(0, 2 ** 62, (1,), generator=generator))
    if rows is not None:
        sigma_normal, noise = rows.take(sigma_normal), rows.take(noise)
    return {"sigma_normal": sigma_normal.to(images.device),
            "noise": noise.to(images.device, images.dtype), "dropout_seed": seed,
            "rows": rows}


def _dropout_generator(d: dict) -> torch.Generator:
    return torch.Generator().manual_seed(int(d["dropout_seed"]))


def _cat_cond(x, cond_img):
    return torch.cat([x, cond_img], dim=-1) if cond_img is not None else x


def diffusion_loss(model, batch: dict, d: dict, cfg: DiffusionLossConfig,
                   training: bool = True):
    """TrigFlow-style EDM loss.  batch: image (N, H, W, C) NHWC, optional
    cond_img (N, H, W, Cc) and cond_inputs list; ``d`` from ``draws``."""
    images = batch["image"]
    cond_img = batch.get("cond_img")
    cond_inputs = batch.get("cond_inputs")
    sd = cfg.sigma_data

    sigma = torch.exp(d["sigma_normal"] * cfg.P_std + cfg.P_mean)
    if cfg.scale_sigma:
        chans = torch.stack([images[..., c] for c in cfg.scaling_channels], dim=-1)
        per_std = torch.std(chans, dim=(1, 2, 3), correction=0).reshape(-1, 1, 1, 1)
        sigma = sigma * torch.clamp(per_std / sd, min=cfg.sigma_scale_eps)

    t = torch.atan(sigma / sd)
    cnoise = t.reshape(-1)
    noise = d["noise"] * sd
    x_t = torch.cos(t) * images + torch.sin(t) * noise
    x = _cat_cond(x_t / sd, cond_img)

    model_output, logvar = model(x, cnoise, cond_inputs, return_logvar=True,
                                 training=training, generator=_dropout_generator(d),
                                 rows=d.get("rows"))
    pred_v_t = -sd * model_output
    v_t = torch.cos(t) * noise - torch.sin(t) * images
    loss = (1.0 / (torch.exp(logvar) * sd ** 2)) * (pred_v_t - v_t) ** 2 + logvar
    return loss.mean(), {"sigma_mean": sigma.mean().detach(),
                         "logvar_mean": logvar.mean().detach()}


@dataclasses.dataclass(frozen=True)
class ConsistencyLossConfig:
    sigma_data: float = 0.5
    P_mean: float = -1.0
    P_std: float = 1.4
    guidance_scale: float = 1.0
    warmup_steps: int = 10_000
    loss_groups: Optional[tuple] = None  # channel group sizes, or None
    use_logvar: bool = True
    const_c: float = 0.1


def warmup_ratio(step: int, warmup_steps: int) -> float:
    """r = min(1, (step + 1) / warmup_steps), in float32 as JAX has it."""
    r = (np.float32(step) + np.float32(1)) / np.float32(max(warmup_steps, 1))
    return float(np.minimum(np.float32(1.0), r))


def consistency_loss(model, teacher_fn: Callable, batch: dict, d: dict,
                     cfg: ConsistencyLossConfig, step: int,
                     guide_fn: Optional[Callable] = None, training: bool = True,
                     return_terms: bool = False):
    """sCM/TrigFlow continuous-time consistency distillation loss.

    The teacher velocity dx_t/dt = sigma_data * -pred (with the optional
    AutoGuidance mix g + s (m - g)) comes from ``teacher_fn`` / ``guide_fn``
    (x, cnoise, cond_inputs) -> prediction, run under ``torch.no_grad()``:
    they are inference forwards (and reach the kernels on the card).  The
    JVP of the negated student through (x_t / sd, t) runs in training mode;
    its tangent F_theta_grad and the primal F_theta_minus are detached (JAX's
    ``stop_gradient``).  With ``return_terms`` the aux dict also holds the
    detached F_theta, F_theta_grad and logvar tensors.
    """
    images = batch["image"]
    cond_img = batch.get("cond_img")
    cond_inputs = batch.get("cond_inputs")
    sd = cfg.sigma_data

    sigma = torch.exp(d["sigma_normal"] * cfg.P_std + cfg.P_mean)
    t = torch.atan(sigma / sd)
    z = d["noise"] * sd
    x_t = torch.cos(t) * images + torch.sin(t) * z

    cnoise = t.reshape(-1)
    with torch.no_grad():
        m_pred = teacher_fn(_cat_cond(x_t / sd, cond_img), cnoise, cond_inputs)
        if guide_fn is not None:
            g_pred = guide_fn(_cat_cond(x_t / sd, cond_img), cnoise, cond_inputs)
            pretrain_pred = g_pred + cfg.guidance_scale * (m_pred - g_pred)
        else:
            pretrain_pred = m_pred
        dxt_dt = sd * -pretrain_pred

    def model_wrapper(x_over_sd, t_in):
        pred, logvar = model(_cat_cond(x_over_sd, cond_img), t_in.reshape(-1), cond_inputs,
                             return_logvar=True, training=training,
                             generator=_dropout_generator(d), rows=d.get("rows"))
        return -pred, logvar

    v_x = torch.cos(t) * torch.sin(t) * dxt_dt / sd
    v_t = torch.cos(t) * torch.sin(t)
    (F_theta, logvar), (F_theta_grad, _) = torch.func.jvp(
        model_wrapper, (x_t / sd, t), (v_x, v_t))
    F_theta_grad = F_theta_grad.detach()
    F_theta_minus = F_theta.detach()
    logvar = logvar.reshape(-1, 1, 1, 1)

    r = warmup_ratio(step, cfg.warmup_steps)
    g = -torch.cos(t) * torch.cos(t) * (sd * F_theta_minus - dxt_dt)
    g = g + (-r * torch.cos(t) * torch.sin(t) * x_t - r * sd * F_theta_grad)

    if cfg.loss_groups is None:
        g_norm = torch.sqrt(torch.mean(g ** 2, dim=(1, 2, 3), keepdim=True))
    else:
        # the MEAN of per-group norms, applied to all channels alike (JAX and
        # the reference stack the group norms and mean over them)
        norms, c = [], 0
        for gc in cfg.loss_groups:
            norms.append(torch.sqrt(torch.mean(g[..., c:c + gc] ** 2, dim=(1, 2, 3),
                                               keepdim=True)))
            c += gc
        g_norm = torch.stack(norms, dim=1).mean(dim=1)
    g = g / (g_norm + cfg.const_c)

    err2 = torch.square(F_theta - F_theta_minus - g)
    if cfg.use_logvar:
        loss = (1.0 / torch.exp(logvar)) * err2 + logvar
    else:
        loss = err2
    if cfg.loss_groups is None:
        loss = loss.mean()
    else:
        parts, c = [], 0
        for gc in cfg.loss_groups:
            parts.append(loss[..., c:c + gc].mean())
            c += gc
        loss = torch.stack(parts).mean()
    aux = {"sigma_mean": sigma.mean(), "r": torch.tensor(r),
           "max_g_norm": g_norm.max(),
           "max_f_grad_norm": torch.sqrt(torch.mean(F_theta_grad ** 2, dim=(1, 2, 3))).max()}
    if return_terms:
        aux.update(F_theta=F_theta_minus, F_theta_grad=F_theta_grad, logvar=logvar.detach())
    return loss, aux


def autoencoder_loss(ae, batch: dict, key, kl_weight: float = 1e-5,
                     perceptual_fn: Optional[Callable] = None,
                     perceptual_weight: float = 1.0, rows=None):
    """VAE loss: MAE + kl_weight * KL (+ perceptual_weight * the optional
    perceptual term), the same for training and validation: both draw a
    posterior sample, from the threefry ``key`` (``ops/noise_field.py``,
    JAX's ``key``: the same key gives JAX's eps; for the global batch, cut
    to ``rows``, in data-parallel training)."""
    images = batch["image"]
    means, logvars = ae.preencode(images)
    z = ae.postencode(means, logvars, key=key, rows=rows)
    recon = ae.decode(z)
    mae = torch.abs(recon - images).mean()
    kl = 0.5 * (means ** 2 + torch.exp(logvars) - 1.0 - logvars).mean()
    loss = mae + kl_weight * kl
    aux = {"mae": mae.detach(), "kl": kl.detach()}
    if perceptual_fn is not None:
        p = perceptual_fn(recon, images)
        loss = loss + perceptual_weight * p
        aux["perceptual"] = p.detach()
    return loss, aux


def key_from_generator(generator: torch.Generator):
    """A threefry key seeded by an int32 drawn from ``generator``: the
    step's key where a loss draws as JAX does (``jax.random.key(seed)``
    with the same seed gives the same draws)."""
    from terrain_diffusion_tpu_torch.ops.noise_field import key_from_seed

    return key_from_seed(int(torch.randint(0, 2 ** 31, (1,), generator=generator)))


# ---------------------------------------------------------------------------
# Optimizer and train step
# ---------------------------------------------------------------------------

def trained_tensors(model) -> dict:
    """The tensors training updates, by state-dict name, each set to require
    grad: the leaves of JAX's parameter tree (``name_map``), that is every
    parameter and also the Fourier and positional embeddings' freqs and
    phases, which JAX's trainer updates as parameters where the reference
    keeps them as buffers."""
    state = model.state_dict(keep_vars=True)
    out = {}
    for name, _path, _linear in name_map(model):
        out[name] = state[name].requires_grad_(True)
    return out


class ClippedAdam:
    """optax's ``chain(clip_by_global_norm(grad_clip), scale_by_adam(b1, b2,
    eps), scale(-1), scale(lr))`` over named tensors, written out:

    - clip: with the global norm n of the gradients, each g becomes
      (g / n) * grad_clip where n >= grad_clip, else stays (optax's rule;
      ``torch.nn.utils.clip_grad_norm_`` divides by n + 1e-6 instead);
    - Adam: mu = (1 - b1) g + b1 mu, nu = (1 - b2) g^2 + b2 nu, count + 1,
      update = mu_hat / (sqrt(nu_hat) + eps) with mu_hat = mu / (1 - b1^count)
      and nu_hat = nu / (1 - b2^count), the corrections in float32;
    - the parameter becomes p + (-update) * lr.
    """

    def __init__(self, betas=(0.9, 0.99), eps: float = 1e-8, grad_clip: float = 10.0):
        self.b1, self.b2 = float(betas[0]), float(betas[1])
        self.eps = float(eps)
        self.grad_clip = float(grad_clip)

    def init(self, params: dict) -> dict:
        return {"count": 0,
                "mu": {k: torch.zeros_like(p) for k, p in params.items()},
                "nu": {k: torch.zeros_like(p) for k, p in params.items()}}

    @torch.no_grad()
    def update(self, params: dict, grads: dict, state: dict, lr: float,
               b2: Optional[float] = None) -> torch.Tensor:
        """Apply one update to ``params`` in place; returns the gradients'
        global norm (before clipping).  ``b2`` replaces the optimizer's for
        this step, moment and bias correction alike (optax's
        ``inject_hyperparams``)."""
        b2 = self.b2 if b2 is None else float(b2)
        g_norm = torch.sqrt(sum(torch.sum(g * g) for g in grads.values()))
        keep = g_norm < self.grad_clip
        state["count"] += 1
        count = state["count"]
        f32, dev = torch.float32, g_norm.device
        c1 = (1 - torch.tensor(self.b1, dtype=f32) ** count).to(dev)
        c2 = (1 - torch.tensor(b2, dtype=f32) ** count).to(dev)
        for k, p in params.items():
            g = grads[k]
            g = torch.where(keep, g, (g / g_norm) * self.grad_clip)
            mu, nu = state["mu"][k], state["nu"][k]
            mu.copy_((1 - self.b1) * g + self.b1 * mu)
            nu.copy_((1 - b2) * (g * g) + b2 * nu)
            upd = (mu / c1) / (torch.sqrt(nu / c2) + self.eps)
            p.copy_(p + (upd * -1.0) * lr)
        return g_norm


def make_optimizer(betas=(0.9, 0.99), eps: float = 1e-8,
                   grad_clip: float = 10.0) -> ClippedAdam:
    """Adam with global-norm clipping; the learning rate is given per step
    from the host-side schedule."""
    return ClippedAdam(betas=betas, eps=eps, grad_clip=grad_clip)


def gradients(params: dict, loss=None) -> dict:
    """Each parameter's gradient (zeros where the loss does not reach it),
    from ``.grad`` after ``loss.backward()``, or by ``torch.autograd.grad``
    of ``loss`` where given; in a process group, averaged over the ranks."""
    if loss is None:
        grads = [p.grad for p in params.values()]
    else:
        grads = torch.autograd.grad(loss, list(params.values()), allow_unused=True)
    grads = {k: g if g is not None else torch.zeros_like(p)
             for (k, p), g in zip(params.items(), grads)}
    all_reduce_mean_(grads.values())
    return grads


def make_train_step(loss_fn: Callable, optimizer: ClippedAdam, renorm_weights: bool = True):
    """``step(model, opt_state, batch, generator, lr) -> metrics``: the loss
    ``loss_fn(model, batch, generator) -> (loss, aux)``, its gradients
    (averaged over the ranks in a process group), one optimizer update of
    the model's ``trained_tensors`` in place and, with ``renorm_weights``,
    ``normalize_weights_``.  Metrics are detached 0-d tensors (no host sync
    here): loss, grad_norm and the loss's aux."""

    def step(model, opt_state, batch, generator, lr):
        params = trained_tensors(model)
        for p in params.values():
            p.grad = None
        loss, aux = loss_fn(model, batch, generator)
        loss.backward()
        g_norm = optimizer.update(params, gradients(params), opt_state, lr)
        for p in params.values():
            p.grad = None
        if renorm_weights:
            normalize_weights_(model)
        return {"loss": loss.detach(), "grad_norm": g_norm,
                **{k: v for k, v in aux.items() if v.dim() == 0}}

    return step
