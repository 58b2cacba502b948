"""InfiniteDiffusion output quality and its tiling ablations (counterpart of
``terrain_diffusion_tpu.evaluation.infinite_consistency``).

Tiled 2-step consistency sampling of base latents over an extended canvas
(64-px tiles at stride 32), a central 64-px crop, a consistency decode x8
and the signed square, then KID / FID of the decoded terrain against real
DEM crops of the validation set.  Modes:

- ``blend``     - full InfiniteDiffusion phase blending (linear windows)
- ``constant``  - constant blend windows
- ``naive``     - independent per-tile sampling, no inter-phase blending
- ``skip-edge`` - no blending on the final phase

``generate_samples`` runs on the models' device; ``evaluate`` and the CLI
read the validation set from an HDF5 file (h5py).

Run (on the card unless ``--device cpu``):
    python -m terrain_diffusion_tpu_torch.evaluation.infinite_consistency \\
        <base_dir> <decoder_dir> --h5-file data/dataset.h5
"""
from __future__ import annotations

import json

import click
import numpy as np

from terrain_diffusion_tpu_torch.common.cli_helpers import click_check_device

from terrain_diffusion_tpu_torch.evaluation import constant_weight_window, linear_weight_window
from terrain_diffusion_tpu_torch.evaluation.metrics import (compute_fid_kid,
                                                            normalize_terrain_for_metric,
                                                            resolve_feature_fn)
from terrain_diffusion_tpu_torch.evaluation.samplers import (compose_terrain,
                                                             process_cond_img,
                                                             sample_base_consistency,
                                                             sample_decoder_consistency_tiled)
from terrain_diffusion_tpu_torch.ops.noise_field import key_from_seed, split


def generate_samples(base_model, decoder_model, cond_imgs, cond_means, cond_stds, *, key,
                     canvas: int = 192, crop: int = 64, mode: str = "blend",
                     inter_t: float = float(np.arctan(0.35 / 0.5)),
                     latent_compression: int = 8) -> np.ndarray:
    """Decoded terrain crops (B, crop * 8, crop * 8, 1) in meters for a batch
    of conditioning images.  ``naive`` samples a 2x2 grid of independent
    crop-size tiles (per-tile windows at 2-block stride), decodes them
    independently and stitches them, so the seams fall inside the metric
    image; the other modes tile the whole canvas with overlap blending and
    crop its centre."""
    if crop != 64:
        raise ValueError(f"crop={crop} unsupported: the tile / conditioning geometry is only "
                         "defined for the reference's 64-latent-px tiles")
    b = cond_imgs.shape[0]
    _key, k1, k2 = split(key, 3)
    if mode == "naive":
        cw = cond_imgs.shape[-1]
        if cw < 6:
            raise ValueError(f"naive mode needs a >=6-wide cond image, got {cw}")
        c0 = (cw - 6) // 2
        cond6 = cond_imgs[:, :, c0:c0 + 6, c0:c0 + 6]
        rows = []
        for gi in range(2):
            row = []
            for gj in range(2):
                vec = process_cond_img(cond6[:, :, gi * 2:gi * 2 + 4, gj * 2:gj * 2 + 4],
                                       np.zeros(5, np.float32), cond_means, cond_stds)
                k1, sub = split(k1)
                row.append(sample_base_consistency(base_model, (b, crop, crop, 5), [vec],
                                                   key=sub, inter_t=inter_t).cpu().numpy())
            rows.append(np.concatenate(row, axis=2))
        latents = np.concatenate(rows, axis=1)  # (B, 2 crop, 2 crop, 5)
    else:
        wfn = constant_weight_window if mode == "constant" else linear_weight_window
        latents = sample_base_consistency(
            base_model, (b, canvas, canvas, 5), cond_imgs, key=k1, inter_t=inter_t,
            tile_size=crop, cond_means=cond_means, cond_stds=cond_stds,
            histogram_raw=np.zeros(5, np.float32), weight_window_fn=wfn,
            skip_blend_last=(mode == "skip-edge")).cpu().numpy()
        c0 = (latents.shape[1] - crop) // 2
        latents = latents[:, c0:c0 + crop, c0:c0 + crop, :]
    # tile == stride == crop * 8: each crop-size latent block decodes alone
    size = crop * latent_compression
    residual = sample_decoder_consistency_tiled(decoder_model, latents[..., :4], key=k2,
                                                tile_size=size, stride=size,
                                                latent_compression=latent_compression)
    terrain = compose_terrain(residual[..., 0], latents[..., 4],
                              lowfreq_normalized=True)[..., None]
    if mode == "naive":  # the centre at the blended modes' resolution, seams in frame
        t0 = (terrain.shape[1] - size) // 2
        terrain = terrain[:, t0:t0 + size, t0:t0 + size, :]
    return terrain


def real_terrain_batch(items, out_size: int) -> np.ndarray:
    """(B, out_size, out_size, 1) real terrain in meters from the items'
    ``ground_truth`` (``H5LatentsDataset(val_dset=True)``), signed-squared
    and centre-cropped to the generated resolution."""
    gts = []
    for item in items:
        if "ground_truth" not in item:
            raise ValueError("dataset item has no 'ground_truth': construct the dataset with "
                             "val_dset=True (and an HDF5 file carrying 'residual')")
        gt = np.asarray(item["ground_truth"], np.float32)
        if gt.shape[0] < out_size or gt.shape[1] < out_size:
            raise ValueError(f"ground truth {gt.shape[:2]} smaller than the generated output "
                             f"{out_size}; use dataset crop_size >= canvas")
        gt = np.sign(gt) * np.square(gt)
        y0, x0 = (gt.shape[0] - out_size) // 2, (gt.shape[1] - out_size) // 2
        gts.append(gt[y0:y0 + out_size, x0:x0 + out_size, :1])
    return np.stack(gts)


def evaluate(base_path: str, decoder_path: str, dataset_kwargs: dict, *, n_images: int = 256,
             batch: int = 8, mode: str = "blend", seed: int = 0, features="terrain",
             canvas: int = 192, crop: int = 64, device="cuda") -> dict:
    from terrain_diffusion_tpu_torch.nn import torch_compat
    from terrain_diffusion_tpu_torch.training.datasets import H5LatentsDataset

    base = torch_compat.load_model(base_path, device=device)
    decoder = torch_compat.load_model(decoder_path, device=device)
    # crop_size = canvas: the conditioning image covers every tile window
    ds = H5LatentsDataset(**{**dataset_kwargs, "val_dset": True, "crop_size": canvas})
    real, fake = [], []
    key = key_from_seed(seed)
    rng = np.random.default_rng(seed)
    while len(fake) * batch < n_images:
        items = [ds[int(rng.integers(1 << 31))] for _ in range(batch)]
        cond_imgs = np.stack([i["cond_inputs_img"] for i in items])
        key, sub = split(key)
        # the dataset standardized cond_inputs_img already: identity here
        terrain = generate_samples(base, decoder, cond_imgs, np.zeros(7, np.float32),
                                   np.ones(7, np.float32), key=sub, mode=mode, canvas=canvas,
                                   crop=crop)
        fake.append(terrain)
        real.append(real_terrain_batch(items, terrain.shape[1]))
    real = normalize_terrain_for_metric(np.concatenate(real)[..., :1])
    fake = normalize_terrain_for_metric(np.concatenate(fake)[..., :1])
    fid, kid_mean, kid_std = compute_fid_kid(real, fake, feature_fn=resolve_feature_fn(features),
                                             device=device)
    return {"mode": mode, "n_images": len(fake), "kid_mean": kid_mean, "kid_std": kid_std,
            "fid": fid, "features": features if isinstance(features, str) else "custom"}


@click.command()
@click.argument("base_path")
@click.argument("decoder_path")
@click.option("--h5-file", required=True)
@click.option("--n-images", type=int, default=256)
@click.option("--batch", type=int, default=8)
@click.option("--mode", type=click.Choice(["blend", "constant", "naive", "skip-edge"]),
              default="blend")
@click.option("--seed", type=int, default=0)
@click.option("--features", default="terrain",
              help="'terrain' or 'inception[:/path/to/weights]'")
@click.option("--canvas", type=int, default=192,
              help="latent-px canvas the tiled modes generate before the central crop")
@click.option("--crop", type=int, default=64, help="latent-px tile / final crop size")
@click.option("--device", default="cuda", help="--device cpu runs on the CPU")
def main(base_path, decoder_path, h5_file, n_images, batch, mode, seed, features, canvas, crop,
         device):
    """FID/KID of InfiniteDiffusion tiled generation against real DEM crops."""
    click_check_device(device)
    dataset_kwargs = dict(
        h5_file=h5_file, pct_land_ranges=[[0.01, 1]], subset_resolutions=[90],
        subset_weights=[1.0], latents_mean=[0, 0, 0, 0], latents_std=[1, 1, 1, 1],
        split="val", clip_edges=False)
    out = evaluate(base_path, decoder_path, dataset_kwargs, n_images=n_images, batch=batch,
                   mode=mode, seed=seed, features=features, canvas=canvas, crop=crop,
                   device=device)
    print(json.dumps(out, indent=2))
    return out


if __name__ == "__main__":
    main()
