"""In-training KID (counterpart of
``terrain_diffusion_tpu/training/trainers/eval_kid.py``): sample the model on
validation conditioning, decode the latents to terrain when a decoder is
given, and compute KID against the real validation terrain.  The sampling
runs on the model's device (the decoder's 512 x 512 tiles through the
kernels on the card); the keys are threefry keys (``ops/noise_field.py``).
"""
from __future__ import annotations

import numpy as np

from terrain_diffusion_tpu_torch.evaluation.metrics import (compute_kid,
                                                            normalize_terrain_for_metric,
                                                            resolve_feature_fn)
from terrain_diffusion_tpu_torch.evaluation.samplers import (compose_terrain,
                                                             sample_base_consistency,
                                                             sample_base_diffusion,
                                                             sample_decoder_consistency_tiled)
from terrain_diffusion_tpu_torch.ops.noise_field import split


def _latents_to_terrain(latents_unit, decoder, key, *, latents_mean=None, latents_std=None,
                        residual_mean=0.0, residual_std=1.1678, latent_compression=8):
    """Sampled latents (``denoised / sigma_data``: channels 0-3 normalized
    VAE latents, channel 4 the normalized lowfreq) -> terrain in meters.
    The decoder was trained on raw VAE latents, so they are de-normalized
    first; its output, a normalized residual, composes with the lowfreq."""
    lat = np.asarray(latents_unit[..., :4], np.float32)
    if latents_std is not None:
        lat = lat * np.asarray(latents_std, np.float32).reshape(1, 1, 1, -1)
    if latents_mean is not None:
        lat = lat + np.asarray(latents_mean, np.float32).reshape(1, 1, 1, -1)
    tile = lat.shape[1] * latent_compression
    residual_unit = sample_decoder_consistency_tiled(
        decoder, lat, key=key, tile_size=tile, stride=tile,
        latent_compression=latent_compression)
    return compose_terrain(residual_unit[..., 0], latents_unit[..., 4], lowfreq_normalized=True,
                           residual_mean=residual_mean, residual_std=residual_std)


def evaluate_kid(model, val_dataset, key, *, mode: str = "base", n_images: int = 128,
                 batch: int = 8, steps: int = 12, sampler: str = "diffusion",
                 inter_t: float | None = None, decoder=None, guide=None,
                 guidance_scale: float = 1.0, features="terrain",
                 sigma_data: float = 0.5) -> dict:
    """KID of model samples against the validation data.  With
    ``mode='base'`` and a ``decoder`` module, sampled latents decode to
    terrain and compare against the items' real ``ground_truth`` terrain
    (or, for a latents-only set, the decoded ground-truth latents);
    otherwise the comparison is in the dataset's latent image space."""
    device = next(model.parameters()).device
    rng = np.random.default_rng(0)
    real, fake = [], []
    lat_mean = getattr(val_dataset, "latents_mean", None)
    lat_std = getattr(val_dataset, "latents_std", None)
    while len(fake) * batch < n_images:
        items = [val_dataset[int(rng.integers(1 << 31))] for _ in range(batch)]
        conds = [np.stack([i["cond_inputs"][0] for i in items])]
        gt = np.stack([i["image"] for i in items])
        key, sub = split(key)
        if sampler == "consistency":
            out = sample_base_consistency(model, gt.shape, conds, key=sub, inter_t=inter_t)
        else:
            out = sample_base_diffusion(model, gt.shape, conds, key=sub, steps=steps,
                                        guide_model=guide, guidance_scale=guidance_scale)
        out = out.cpu().numpy()  # denoised / sigma_data (normalized units)
        if mode == "base" and decoder is not None and gt.shape[-1] >= 5:
            key, k1 = split(key)
            fake.append(_latents_to_terrain(out, decoder, k1, latents_mean=lat_mean,
                                            latents_std=lat_std)[..., None])
            if all("ground_truth" in i for i in items):
                gt_sqrt = np.stack([np.asarray(i["ground_truth"], np.float32)[..., 0]
                                    for i in items])
                real.append((np.sign(gt_sqrt) * gt_sqrt ** 2)[..., None])
            else:  # a latents-only set: decode the ground-truth latents instead
                key, k2 = split(key)
                real.append(_latents_to_terrain(gt / sigma_data, decoder, k2,
                                                latents_mean=lat_mean,
                                                latents_std=lat_std)[..., None])
        else:  # latent-space KID, in the dataset's image space
            fake.append(out * sigma_data)
            real.append(gt)
    real = normalize_terrain_for_metric(np.concatenate(real)[..., :1])
    fake = normalize_terrain_for_metric(np.concatenate(fake)[..., :1])
    kid_mean, kid_std = compute_kid(real, fake, n_subsets=50, subset_size=min(len(real), 64),
                                    feature_fn=resolve_feature_fn(features), device=device)
    return {"kid_mean": kid_mean, "kid_std": kid_std, "n_images": len(fake)}
