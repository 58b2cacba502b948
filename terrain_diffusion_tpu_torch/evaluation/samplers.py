"""Bounded-canvas tiled samplers for evaluation and sweeps (counterpart of
``terrain_diffusion_tpu.evaluation.samplers``).

Plain functions under ``torch.no_grad()`` over the port's ``nn.Module``
models: the models hold their weights (JAX passes ``params``), and every
draw comes from an explicit threefry key (``ops/noise_field.py``:
``key_from_seed`` / ``split`` / ``normal``), so the same key gives JAX's
noise.  Inputs may be numpy arrays or tensors; the samplers run on the
model's device and return tensors there.  Tiles blend with the weight
windows as the pipeline blends them (weighted sum, then divide).  A model
forward on the card takes the fused-block and 3x3-conv kernels on maps of
128 x 128 pixels and up, and the attention kernel where the model's
blocks ask for it (``nn/layers.py``).
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from terrain_diffusion_tpu_torch.evaluation import tile_starts
from terrain_diffusion_tpu_torch.ops import mp
from terrain_diffusion_tpu_torch.ops.laplacian import laplacian_decode, laplacian_denoise
from terrain_diffusion_tpu_torch.ops.noise_field import normal, split
from terrain_diffusion_tpu_torch.ops.windows import linear_weight_window
from terrain_diffusion_tpu_torch.scheduler.dpmsolver import (EDMSchedulerConfig, compute_sigmas,
                                                             sample_dpm,
                                                             scale_score_in_velocity,
                                                             trigflow_precondition_noise)

LOWFREQ_MEAN, LOWFREQ_STD = -31.4, 38.6
f32 = np.float32


def _device(model) -> torch.device:
    return next(model.parameters()).device


def _tensor(a, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a, np.float32) if not isinstance(a, torch.Tensor)
                           else a, dtype=torch.float32, device=device)


def _trig(t: float):
    """cos(t), sin(t) of a float32 t, in float32."""
    return float(np.cos(f32(t))), float(np.sin(f32(t)))


def _weights(fn: Callable, tile: int, device) -> torch.Tensor:
    return torch.from_numpy(np.asarray(fn(tile), np.float32))[None, :, :, None].to(device)


def _upsample(latents: torch.Tensor, factor: int) -> torch.Tensor:
    """Nearest-neighbour upsampling of an NHWC tensor."""
    return latents.repeat_interleave(factor, dim=1).repeat_interleave(factor, dim=2)


@torch.no_grad()
def compose_terrain(residual_unit, lowfreq, *, lowfreq_normalized=False,
                    residual_mean: float = 0.0, residual_std: float = 1.1678,
                    denoise: bool = True, extrapolate: bool = True) -> np.ndarray:
    """Normalized decoder residual (B, H, W) (+ lowfreq (B, h, w)) -> terrain
    in meters: de-normalize, ``laplacian_denoise(sigma=5)``, extrapolated
    ``laplacian_decode``, signed square (the one chain every eval that
    compares decoded terrain against real DEM data goes through)."""
    device = residual_unit.device if isinstance(residual_unit, torch.Tensor) else "cpu"
    hf = _tensor(residual_unit, device) * residual_std + residual_mean
    lf = _tensor(lowfreq, device)
    if lowfreq_normalized:
        lf = lf * LOWFREQ_STD + LOWFREQ_MEAN
    if denoise:
        hf, lf = laplacian_denoise(hf, lf, 5.0)
    elev = laplacian_decode(hf, lf, extrapolate=extrapolate).cpu().numpy()
    return np.sign(elev) * elev ** 2


def process_cond_img(cond_img, histogram_raw, cond_means, cond_stds,
                     noise_level: float = 0.0, device=None) -> torch.Tensor:
    """(B, 7, 4, 4) conditioning window -> (B, 58) vector, as the pipeline
    conditions its latent tiles (every channel's NaNs become cond_means[0]
    in normalized space)."""
    device = device or (cond_img.device if isinstance(cond_img, torch.Tensor) else "cpu")
    cond_img = _tensor(cond_img, device)
    cm = np.asarray(cond_means, np.float32)
    m = _tensor(cm, device).reshape(1, -1, 1, 1)
    s = _tensor(cond_stds, device).reshape(1, -1, 1, 1)
    cond = torch.nan_to_num((cond_img - m) / s, nan=float(cm[0]))
    b = cond.shape[0]
    means_crop = cond[:, 0].reshape(b, -1)
    p5_crop = cond[:, 1].reshape(b, -1)
    climate = cond[:, 2:6, 1:3, 1:3].mean(dim=(2, 3))
    mask_crop = cond[:, 6].reshape(b, -1)
    nl = torch.full((b, 1), float(f32((noise_level - 0.5) * np.sqrt(12))), device=device)
    hist = _tensor(histogram_raw, device).reshape(1, -1).expand(b, 5)
    return mp.mp_concat([means_crop, p5_crop, climate, mask_crop, hist, nl], dim=1)


def _with_guidance(model, guide_model=None, guidance_scale: float = 1.0):
    def fwd(x, cnoise, cond_inputs):
        out = model(x, cnoise, cond_inputs)
        if guide_model is not None and guidance_scale != 1.0:
            g = guide_model(x, cnoise, cond_inputs)
            out = g + guidance_scale * (out - g)
        return out
    return fwd


def _dpm_tile(model, guide_model, guidance_scale, steps, cfg, noise, cond_list,
              cond_img=None, score_scaling: float = 1.0):
    """DPM-Solver++ over one tile; ``cond_img`` is channel-concatenated to
    the model input (decoder / coarse paths)."""
    fwd = _with_guidance(model, guide_model, guidance_scale)
    sd = cfg.sigma_data

    def model_fn(scaled, sigma):
        nl = torch.full((noise.shape[0],), float(trigflow_precondition_noise(sigma, sd)),
                        device=scaled.device, dtype=scaled.dtype)
        if cond_img is None:
            return fwd(scaled, nl, cond_list)
        v = fwd(torch.cat([scaled, cond_img], dim=-1), nl, cond_list)
        if score_scaling != 1.0:
            # the score direction needs the raw sigma-space sample
            raw = scaled * float(np.sqrt(f32(f32(sigma) ** 2 + f32(sd) ** 2)))
            v = scale_score_in_velocity(v, raw, float(sigma), v, alpha=score_scaling,
                                        sigma_data=sd)
        return v

    return sample_dpm(model_fn, noise, cfg, steps)


def _consistency_step(model, cfg, sample, z, t, cond_list):
    sd = cfg.sigma_data
    ct, st = _trig(t)
    x_t = ct * sample + st * z * sd
    nl = torch.full((x_t.shape[0],), float(f32(t)), device=x_t.device, dtype=x_t.dtype)
    pred = -model(x_t / sd, nl, cond_list)
    return ct * x_t - st * sd * pred


@torch.no_grad()
def sample_base_diffusion(model, shape, cond_inputs, *, key, steps: int = 15,
                          cfg: EDMSchedulerConfig | None = None, guide_model=None,
                          guidance_scale: float = 1.0, tile_size: Optional[int] = None,
                          cond_means=None, cond_stds=None, histogram_raw=None,
                          noise_level: float = 0.0,
                          weight_window_fn: Callable = linear_weight_window) -> torch.Tensor:
    """(B, H, W, C) latents by DPM-Solver++, optionally tiled.  Untiled,
    ``cond_inputs`` is the list of per-sample conditioning arrays; tiled, a
    (B, 7, Hc, Wc) conditioning image (4x4 windows -> 58-dim vectors)."""
    cfg = cfg or EDMSchedulerConfig()
    dev = _device(model)
    sigmas0 = float(compute_sigmas(cfg, steps)[0])
    b, h, w, c = shape

    def run_tile(noise, tile_cond):
        return _dpm_tile(model, guide_model, guidance_scale, steps, cfg, noise, tile_cond)

    noise = normal(key, shape, dev) * sigmas0
    if tile_size is None:
        return run_tile(noise, [_tensor(ci, dev) for ci in cond_inputs]) / cfg.sigma_data
    stride = tile_size // 2
    cond_img = np.asarray(cond_inputs)
    if cond_img.ndim != 4:
        raise ValueError("tiled sampling needs a (B, 7, Hc, Wc) cond image")
    weights = _weights(weight_window_fn, tile_size, dev)
    out = torch.zeros(shape, device=dev)
    out_w = torch.zeros(shape, device=dev)
    for ic, i0 in enumerate(tile_starts(h, tile_size, stride)):
        for jc, j0 in enumerate(tile_starts(w, tile_size, stride)):
            tc = process_cond_img(cond_img[:, :, ic:ic + 4, jc:jc + 4], histogram_raw,
                                  cond_means, cond_stds, noise_level, device=dev)
            sl = (slice(None), slice(i0, i0 + tile_size), slice(j0, j0 + tile_size))
            tile = run_tile(noise[sl], [tc])
            out[sl] += tile * weights
            out_w[sl] += weights.expand(tile.shape)
    return out / out_w / cfg.sigma_data


@torch.no_grad()
def sample_base_consistency(model, shape, cond_inputs, *, key, inter_t: float | None = None,
                            cfg: EDMSchedulerConfig | None = None,
                            tile_size: Optional[int] = None, cond_means=None, cond_stds=None,
                            histogram_raw=None,
                            weight_window_fn: Callable = linear_weight_window,
                            skip_blend_last: bool = False) -> torch.Tensor:
    """1-2 step TrigFlow consistency sampling with optional inter-step
    blending (the bounded-canvas InfiniteDiffusion analogue)."""
    cfg = cfg or EDMSchedulerConfig()
    dev = _device(model)
    sd = cfg.sigma_data
    sigmas0 = float(compute_sigmas(cfg, 20)[0])
    t_steps = [float(np.arctan(sigmas0 / sd))]
    if inter_t is not None:
        t_steps.append(float(inter_t))
    b, h, w, c = shape
    sample = torch.zeros(shape, device=dev)
    if tile_size is None:
        cond = [_tensor(ci, dev) for ci in cond_inputs]
        for t in t_steps:
            key, sub = split(key)
            sample = _consistency_step(model, cfg, sample, normal(sub, shape, dev), t, cond)
        return sample / sd
    stride = tile_size // 2
    cond_img = np.asarray(cond_inputs)
    weights = _weights(weight_window_fn, tile_size, dev)
    for si, t in enumerate(t_steps):
        key, sub = split(key)
        z_full = normal(sub, shape, dev)
        out = torch.zeros(shape, device=dev)
        out_w = torch.zeros(shape, device=dev)
        wt = torch.ones_like(weights) if (si == len(t_steps) - 1 and skip_blend_last) \
            else weights
        for ic, i0 in enumerate(tile_starts(h, tile_size, stride)):
            for jc, j0 in enumerate(tile_starts(w, tile_size, stride)):
                tc = [process_cond_img(cond_img[:, :, ic:ic + 4, jc:jc + 4], histogram_raw,
                                       cond_means, cond_stds, device=dev)]
                sl = (slice(None), slice(i0, i0 + tile_size), slice(j0, j0 + tile_size))
                tile = _consistency_step(model, cfg, sample[sl], z_full[sl], t, tc)
                out[sl] += tile * wt
                out_w[sl] += wt.expand(tile.shape)
        sample = out / out_w
    return sample / sd


@torch.no_grad()
def sample_decoder_consistency_tiled(model, latents, *, key, tile_size: int = 512,
                                     stride: int = 384, latent_compression: int = 8,
                                     cfg: EDMSchedulerConfig | None = None,
                                     weight_window_fn: Callable = linear_weight_window
                                     ) -> torch.Tensor:
    """1-step consistency decode of (B, h, w, 4) latents to the (B, H, W, 1)
    normalized residual over overlapping pixel tiles."""
    cfg = cfg or EDMSchedulerConfig()
    dev = _device(model)
    sd = cfg.sigma_data
    t = float(np.arctan(float(compute_sigmas(cfg, 20)[0]) / sd))
    ct, st = _trig(t)
    lc = latent_compression
    latents = _tensor(latents, dev)
    b, h, w, _ = latents.shape
    hh, ww = h * lc, w * lc
    up = _upsample(latents, lc)
    weights = _weights(weight_window_fn, tile_size, dev)
    key, sub = split(key)
    z_full = normal(sub, (b, hh, ww, 1), dev)
    out = torch.zeros((b, hh, ww, 1), device=dev)
    out_w = torch.zeros((b, hh, ww, 1), device=dev)
    nl = torch.full((b,), float(f32(t)), device=dev)
    for i0 in tile_starts(hh, tile_size, stride):
        for j0 in tile_starts(ww, tile_size, stride):
            sl = (slice(None), slice(i0, i0 + tile_size), slice(j0, j0 + tile_size))
            x_t = st * z_full[sl] * sd
            pred = -model(torch.cat([x_t / sd, up[sl]], dim=-1), nl, [])
            tile = ct * x_t - st * sd * pred
            out[sl] += tile * weights
            out_w[sl] += weights.expand(tile.shape)
    return out / out_w / sd


@torch.no_grad()
def sample_decoder_diffusion_tiled(model, latents, *, key, steps: int = 15,
                                   tile_size: int = 512, stride: int = 384,
                                   latent_compression: int = 8,
                                   cfg: EDMSchedulerConfig | None = None, guide_model=None,
                                   guidance_scale: float = 1.0, score_scaling: float = 1.0,
                                   weight_window_fn: Callable = linear_weight_window
                                   ) -> torch.Tensor:
    """Multi-step diffusion decode with optional AutoGuidance and score
    scaling."""
    cfg = cfg or EDMSchedulerConfig()
    dev = _device(model)
    sigmas0 = float(compute_sigmas(cfg, steps)[0])
    lc = latent_compression
    latents = _tensor(latents, dev)
    b, h, w, _ = latents.shape
    hh, ww = h * lc, w * lc
    up = _upsample(latents, lc)
    weights = _weights(weight_window_fn, tile_size, dev)
    key, sub = split(key)
    noise_full = normal(sub, (b, hh, ww, 1), dev) * sigmas0
    out = torch.zeros((b, hh, ww, 1), device=dev)
    out_w = torch.zeros((b, hh, ww, 1), device=dev)
    for i0 in tile_starts(hh, tile_size, stride):
        for j0 in tile_starts(ww, tile_size, stride):
            sl = (slice(None), slice(i0, i0 + tile_size), slice(j0, j0 + tile_size))
            tile = _dpm_tile(model, guide_model, guidance_scale, steps, cfg, noise_full[sl],
                             [], cond_img=up[sl], score_scaling=float(score_scaling))
            out[sl] += tile * weights
            out_w[sl] += weights.expand(tile.shape)
    return out / out_w / cfg.sigma_data


@torch.no_grad()
def sample_autoencoder_tiled(ae, x, *, key=None, tile_size: int = 512, stride: int = 384,
                             weight_window_fn: Callable = linear_weight_window) -> torch.Tensor:
    """Tiled VAE encode + decode round trip; with a key, fresh latent noise
    for every tile."""
    dev = _device(ae)
    x = _tensor(x, dev)
    b, h, w, c = x.shape
    weights = _weights(weight_window_fn, tile_size, dev)
    out = torch.zeros_like(x)
    out_w = torch.zeros_like(x)
    for i0 in tile_starts(h, tile_size, stride):
        for j0 in tile_starts(w, tile_size, stride):
            sl = (slice(None), slice(i0, i0 + tile_size), slice(j0, j0 + tile_size))
            sub = None
            if key is not None:
                key, sub = split(key)
            means, logvars = ae.preencode(x[sl])
            rec = ae.decode(ae.postencode(means, logvars, key=sub))
            out[sl] += rec * weights
            out_w[sl] += weights.expand(rec.shape)
    return out / out_w


def cond_inputs_from_snr(cond_snr, batch: int = 1, device="cpu"):
    """Coarse conditioning scalars from per-channel SNR (reference
    ``sample_coarse._cond_inputs_from_snr``)."""
    t = np.arctan(np.asarray(cond_snr, np.float32))
    vals = np.log(np.tan(t) / 8.0)
    return [torch.full((batch,), float(v), device=device) for v in vals], t


@torch.no_grad()
def sample_coarse_tiled(model, cond_map, cond_snr, *, key, steps: int = 20,
                        tile_size: int = 64, cfg: EDMSchedulerConfig | None = None,
                        weight_window_fn: Callable = linear_weight_window) -> torch.Tensor:
    """Tiled 20-step coarse sampling over a normalized (B, H, W, 5) cond map."""
    cfg = cfg or EDMSchedulerConfig()
    dev = _device(model)
    sigmas0 = float(compute_sigmas(cfg, steps)[0])
    cond_map = _tensor(cond_map, dev)
    b, h, w, _ = cond_map.shape
    stride = tile_size - 16
    cond_scalars, t_cond = cond_inputs_from_snr(cond_snr, batch=b, device=dev)
    tc = torch.from_numpy(np.asarray(t_cond, np.float32)).to(dev).reshape(1, 1, 1, -1)
    key, kn = split(key)
    cond_mixed = torch.cos(tc) * cond_map + torch.sin(tc) * normal(kn, cond_map.shape, dev)
    weights = _weights(weight_window_fn, tile_size, dev)
    key, ks = split(key)
    noise_full = normal(ks, (b, h, w, 6), dev) * sigmas0
    out = torch.zeros((b, h, w, 6), device=dev)
    out_w = torch.zeros((b, h, w, 6), device=dev)
    for i0 in tile_starts(h, tile_size, stride):
        for j0 in tile_starts(w, tile_size, stride):
            sl = (slice(None), slice(i0, i0 + tile_size), slice(j0, j0 + tile_size))
            tile = _dpm_tile(model, None, 1.0, steps, cfg, noise_full[sl], cond_scalars,
                             cond_img=cond_mixed[sl])
            out[sl] += tile * weights
            out_w[sl] += weights.expand(tile.shape)
    return out / out_w / cfg.sigma_data
