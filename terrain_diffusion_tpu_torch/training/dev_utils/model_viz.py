"""Model-in-the-loop visualizers (counterpart of
``terrain_diffusion_tpu.training.dev_utils.model_viz``): run trained models
on dataset samples and page through inputs / outputs / error maps.

The models load on ``--device`` (the card by default) and run under
``torch.no_grad()``, so their residual blocks, 3x3 convs and midblock
attention take the CUDA kernels where the maps are large enough.  Page i
draws its noise from the threefry key ``key_from_seed(seed + i)``, the
draws of JAX's ``jax.random.key(seed + i)``.
"""
from __future__ import annotations

import click
import numpy as np
import torch

from terrain_diffusion_tpu_torch.common.cli_helpers import click_check_device
from terrain_diffusion_tpu_torch.ops.noise_field import key_from_seed
from terrain_diffusion_tpu_torch.training.dev_utils import (Browser, Page, decode_terrain,
                                                           load_section)


def _load(model_path, device):
    from terrain_diffusion_tpu_torch.nn import torch_compat

    return torch_compat.load_model(model_path, device=device)


def _device(model) -> torch.device:
    return next(model.parameters()).device


def autoencoder_pages(ds, ae, seed: int):
    """Page function of ``autoencoder``: the VAE round trip of item i (on
    the model's device) - input residual, reconstruction, |error| and up to
    four latent means."""
    dev = _device(ae)

    def page(i):
        s = ds[i]
        x = np.asarray(s["image"])[None]
        with torch.no_grad():
            means, logvars = ae.preencode(torch.as_tensor(x, device=dev))
            z = ae.postencode(means, logvars, key=key_from_seed(seed + i))
            rec = ae.decode(z)[0].cpu().numpy()
        means = means[0].cpu().numpy()
        err = np.abs(rec[..., 0] - x[0, ..., 0])
        p = Page(f"AE roundtrip [{i}]  MAE={err.mean():.4f}")
        p.image("input residual", x[0, ..., 0], cmap="terrain")
        p.image("reconstruction", rec[..., 0], cmap="terrain")
        p.image("|error|", err, cmap="magma")
        for c in range(min(means.shape[-1], 4)):
            p.image(f"latent mean[{c}]", means[..., c])
        return p

    return page


@click.command("autoencoder")
@click.option("--config", "config_path", required=True,
              type=click.Path(exists=True))
@click.option("--model-path", required=True)
@click.option("--section", default="val_dataset")
@click.option("--n", type=int, default=4)
@click.option("--out", default="autoencoder_viz.png")
@click.option("--seed", type=int, default=548)
@click.option("--headless/--interactive", default=None)
@click.option("-o", "--override", "overrides", multiple=True)
@click.option("--device", default="cuda", show_default=True,
              help="--device cpu runs on the CPU")
def autoencoder(config_path, model_path, section, n, out, seed, headless,
                overrides, device):
    """VAE roundtrip: input residual, reconstruction, |error|, latents."""
    click_check_device(device)
    ds = load_section(config_path, section, overrides)
    page = autoencoder_pages(ds, _load(model_path, device), seed)
    return Browser(page, n_pages=n, out=out, headless=headless).run()


def base_diffusion_pages(ds, model, seed: int, steps: int, decoder=None):
    """Page function of ``base-diffusion``: latents sampled by DPM-Solver++
    on item i's conditioning beside the dataset's latents, and with a
    consistency ``decoder`` the decoded terrain."""
    from terrain_diffusion_tpu_torch.evaluation.samplers import (
        sample_base_diffusion, sample_decoder_consistency_tiled)

    dev = _device(model)

    def page(i):
        s = ds[i]
        gt = np.asarray(s["image"])  # (H, W, 5): 4 latents + lowfreq
        cond = [np.asarray(c)[None] for c in s.get("cond_inputs", [])]
        key = key_from_seed(seed + i)
        lat = sample_base_diffusion(
            model, (1, gt.shape[0], gt.shape[1], gt.shape[-1]),
            cond, key=key, steps=steps)
        lat = lat[0].cpu().numpy()
        p = Page(f"base diffusion sample [{i}]  steps={steps}")
        for c in range(min(4, lat.shape[-1])):
            p.image(f"sampled latent[{c}]", lat[..., c])
            p.image(f"gt latent[{c}]", gt[..., c])
        if lat.shape[-1] >= 5:
            p.image("sampled lowfreq", lat[..., 4], cmap="terrain")
            p.image("gt lowfreq", gt[..., 4], cmap="terrain")
        if decoder is not None and lat.shape[-1] >= 5:
            res = sample_decoder_consistency_tiled(
                decoder, lat[None, ..., :4], key=key,
                tile_size=min(512, gt.shape[0] * 8))
            res = res[0, ..., 0].cpu().numpy()
            # sampler outputs are ALREADY denoised/sigma_data (normalized
            # units) - lat[..., 4] is the normalized lowfreq as-is
            terrain = decode_terrain(res, lat[..., 4], device=dev)
            p.image("decoded terrain [m]", terrain, cmap="terrain")
        return p

    return page


@click.command("base-diffusion")
@click.option("--config", "config_path", required=True,
              type=click.Path(exists=True))
@click.option("--model-path", required=True, help="base diffusion model")
@click.option("--decoder-path", default=None,
              help="consistency decoder for latent->terrain decode")
@click.option("--section", default="val_dataset")
@click.option("--n", type=int, default=2)
@click.option("--steps", type=int, default=15)
@click.option("--out", default="base_diffusion_viz.png")
@click.option("--seed", type=int, default=548)
@click.option("--headless/--interactive", default=None)
@click.option("-o", "--override", "overrides", multiple=True)
@click.option("--device", default="cuda", show_default=True,
              help="--device cpu runs on the CPU")
def base_diffusion(config_path, model_path, decoder_path, section, n, steps,
                   out, seed, headless, overrides, device):
    """Sample latents on dataset conditioning with DPM-Solver++, compare to
    the dataset's ground-truth latents; optionally decode to terrain."""
    click_check_device(device)
    ds = load_section(config_path, section, overrides)
    decoder = _load(decoder_path, device) if decoder_path else None
    page = base_diffusion_pages(ds, _load(model_path, device), seed, steps, decoder)
    return Browser(page, n_pages=n, out=out, headless=headless).run()


def consistency_decoder_pages(ds, model, seed: int):
    """Page function of ``consistency-decoder``: the 1-step consistency
    decode of item i's latents beside its residual, in normalized units."""
    from terrain_diffusion_tpu_torch.evaluation.samplers import (
        sample_decoder_consistency_tiled)

    def page(i):
        s = ds[i]
        sigma_data = getattr(ds, "sigma_data", 0.5)
        # dataset image = residual_norm * sigma_data; the sampler returns
        # residual_norm - compare both in normalized units
        gt = np.asarray(s["image"])[..., 0] / sigma_data
        cond = np.asarray(s["cond_img"])  # upsampled latents (H, W, 4)
        lc = max(gt.shape[0] // max(cond.shape[0], 1), 1)
        # cond is already nearest-upsampled; downsample back to latent grid
        lat = cond[::lc, ::lc, :][None] if lc > 1 else cond[None]
        res = sample_decoder_consistency_tiled(
            model, lat, key=key_from_seed(seed + i),
            tile_size=min(512, gt.shape[0]), latent_compression=lc)
        res = res[0, ..., 0].cpu().numpy()
        err = np.abs(res - gt)
        p = Page(f"consistency decode [{i}]  MAE={err.mean():.4f}")
        p.image("gt residual", gt, cmap="terrain")
        p.image("decoded residual", res, cmap="terrain")
        p.image("|error|", err, cmap="magma")
        for c in range(min(4, cond.shape[-1])):
            p.image(f"latent cond[{c}]", cond[..., c])
        return p

    return page


@click.command("consistency-decoder")
@click.option("--config", "config_path", required=True,
              type=click.Path(exists=True))
@click.option("--model-path", required=True, help="consistency decoder")
@click.option("--section", default="val_dataset",
              help="an H5DecoderTerrainDataset section")
@click.option("--n", type=int, default=4)
@click.option("--out", default="decoder_viz.png")
@click.option("--seed", type=int, default=548)
@click.option("--headless/--interactive", default=None)
@click.option("-o", "--override", "overrides", multiple=True)
@click.option("--device", default="cuda", show_default=True,
              help="--device cpu runs on the CPU")
def consistency_decoder(config_path, model_path, section, n, out, seed,
                        headless, overrides, device):
    """1-step consistency decode of dataset latents vs ground-truth
    residual."""
    click_check_device(device)
    ds = load_section(config_path, section, overrides)
    page = consistency_decoder_pages(ds, _load(model_path, device), seed)
    return Browser(page, n_pages=n, out=out, headless=headless).run()


if __name__ == "__main__":
    autoencoder()
