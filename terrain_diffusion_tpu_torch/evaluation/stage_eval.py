"""Bounded-canvas FID/KID of one model stage (counterpart of
``terrain_diffusion_tpu.evaluation.stage_eval``): one CLI, ``--stage``
choosing the experiment, with the ``--disable-laplacian-denoising``
ablation for the decoder stages.  The datasets read HDF5 files (h5py).

Run (on the card unless ``--device cpu``):
    python -m terrain_diffusion_tpu_torch.evaluation.stage_eval <model_dir> \\
        --stage base_consistency --h5-file data/dataset.h5
"""
from __future__ import annotations

import json

import click
import numpy as np

from terrain_diffusion_tpu_torch.common.cli_helpers import click_check_device

from terrain_diffusion_tpu_torch.evaluation.metrics import (compute_fid_kid,
                                                            normalize_terrain_for_metric,
                                                            resolve_feature_fn)
from terrain_diffusion_tpu_torch.evaluation.samplers import (compose_terrain,
                                                             sample_base_consistency,
                                                             sample_base_diffusion,
                                                             sample_decoder_consistency_tiled,
                                                             sample_decoder_diffusion_tiled)
from terrain_diffusion_tpu_torch.ops.noise_field import key_from_seed, split


def run_stage_eval(stage: str, model_path: str, h5_file: str, *, features="terrain",
                   guide_path: str | None = None, guidance_scale: float = 1.0,
                   n_images: int = 256, batch: int = 8, steps: int = 15, seed: int = 0,
                   inter_t: float | None = None, disable_laplacian_denoising: bool = False,
                   device="cuda") -> dict:
    from terrain_diffusion_tpu_torch.nn import torch_compat
    from terrain_diffusion_tpu_torch.training.datasets import (H5DecoderTerrainDataset,
                                                               H5LatentsDataset)

    model = torch_compat.load_model(model_path, device=device)
    guide = torch_compat.load_model(guide_path, device=device) if guide_path else None
    key = key_from_seed(seed)
    rng = np.random.default_rng(seed)
    real, fake = [], []
    if stage in ("base_diffusion", "base_consistency"):
        ds = H5LatentsDataset(
            h5_file=h5_file, crop_size=64, pct_land_ranges=[[0, 1]], subset_resolutions=[90],
            subset_weights=[1.0], latents_mean=[0, 0, 0, 0], latents_std=[1, 1, 1, 1],
            split="val")
        while len(fake) * batch < n_images:
            items = [ds[int(rng.integers(1 << 31))] for _ in range(batch)]
            conds = [np.stack([i["cond_inputs"][0] for i in items])]
            gt = np.stack([i["image"] for i in items])
            key, sub = split(key)
            if stage == "base_diffusion":
                out = sample_base_diffusion(model, gt.shape, conds, key=sub, steps=steps,
                                            guide_model=guide, guidance_scale=guidance_scale)
            else:
                out = sample_base_consistency(
                    model, gt.shape, conds, key=sub,
                    inter_t=float(np.arctan(0.35 / 0.5)) if inter_t is None else float(inter_t))
            real.append(gt)
            # the samplers return denoised / sigma_data; the dataset image
            # carries the sigma_data factor: compare in the dataset's space
            fake.append(out.cpu().numpy() * 0.5)
    elif stage in ("decoder_consistency", "decoder_diffusion"):
        ds = H5DecoderTerrainDataset(
            h5_file=h5_file, crop_size=64, pct_land_ranges=[[0, 1]], subset_resolutions=[90],
            residual_mean=0.0, residual_std=1.1678, split="val")
        while len(fake) * batch < n_images:
            items = [ds[0] for _ in range(batch)]
            latents = np.stack([i["cond_img"][::8, ::8, :] for i in items])
            gt = np.stack([i["image"] for i in items])
            lowfreq = np.stack([i["lowfreq"] for i in items])
            key, sub = split(key)
            size = gt.shape[1]
            if stage == "decoder_consistency":
                out = sample_decoder_consistency_tiled(model, latents, key=sub, tile_size=size,
                                                       stride=size)
            else:
                out = sample_decoder_diffusion_tiled(
                    model, latents, key=sub, steps=steps, tile_size=size, stride=size,
                    guide_model=guide, guidance_scale=guidance_scale)
            # one composition chain for both sides, in normalized units
            denoise = not disable_laplacian_denoising
            real.append(compose_terrain(gt[..., 0] / 0.5, lowfreq[..., 0],
                                        residual_mean=ds.residual_mean,
                                        residual_std=ds.residual_std, denoise=denoise))
            fake.append(compose_terrain(out[..., 0], lowfreq[..., 0],
                                        residual_mean=ds.residual_mean,
                                        residual_std=ds.residual_std, denoise=denoise))
    else:
        raise ValueError(f"unknown stage {stage}")
    real, fake = np.concatenate(real), np.concatenate(fake)
    if real.ndim == 3:
        real, fake = real[..., None], fake[..., None]
    real = normalize_terrain_for_metric(real[..., :1])
    fake = normalize_terrain_for_metric(fake[..., :1])
    fid, kid_mean, kid_std = compute_fid_kid(real, fake, feature_fn=resolve_feature_fn(features),
                                             device=device)
    return {"stage": stage, "n_images": len(fake), "kid_mean": kid_mean, "kid_std": kid_std,
            "fid": fid, "features": features if isinstance(features, str) else "custom"}


@click.command()
@click.argument("model_path")
@click.option("--stage", type=click.Choice(["base_diffusion", "base_consistency",
                                            "decoder_consistency", "decoder_diffusion"]),
              required=True)
@click.option("--h5-file", required=True)
@click.option("--guide-path", default=None)
@click.option("--guidance-scale", type=float, default=1.0)
@click.option("--n-images", type=int, default=256)
@click.option("--batch", type=int, default=8)
@click.option("--steps", type=int, default=15)
@click.option("--seed", type=int, default=0)
@click.option("--disable-laplacian-denoising", is_flag=True, default=False)
@click.option("--features", default="terrain",
              help="'terrain' or 'inception[:/path/to/weights]'")
@click.option("--device", default="cuda", help="--device cpu runs on the CPU")
def main(model_path, stage, h5_file, guide_path, guidance_scale, n_images, batch, steps, seed,
         disable_laplacian_denoising, features, device):
    """Bounded-canvas FID/KID for one model stage."""
    click_check_device(device)
    out = run_stage_eval(stage, model_path, h5_file, guide_path=guide_path,
                         guidance_scale=guidance_scale, n_images=n_images, batch=batch,
                         steps=steps, seed=seed,
                         disable_laplacian_denoising=disable_laplacian_denoising,
                         features=features, device=device)
    print(json.dumps(out, indent=2))
    return out


if __name__ == "__main__":
    main()
