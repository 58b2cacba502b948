"""Export terrain to GeoTIFF from a directory of conditioning GeoTIFFs, the
``tiff-export`` command (counterpart of
``terrain_diffusion_tpu.serving.tiff_export``).

Imports the five conditioning channels (64-cell edge padding for smooth
border context) with ``set_custom_conditioning_import``, generates the world
in chunks at 256 px per cell (``world.get(..., with_climate=False)``, whose
decoder stage runs the CUDA kernels on the card) and writes an int16
GeoTIFF.

Run:
    python -m terrain_diffusion_tpu_torch tiff-export <world_dir> <tiff_dir> out.tif
"""
from __future__ import annotations

from pathlib import Path

import click
import numpy as np
from tqdm import tqdm

from terrain_diffusion_tpu_torch.common.cli_helpers import (click_check_device,
                                                           parse_batch_sizes, parse_cache_size)
from terrain_diffusion_tpu_torch.common.geotiff import read_geotiff, write_geotiff
from terrain_diffusion_tpu_torch.pipeline.world import WorldPipeline

PADDING = 64
PIXELS_PER_CELL = 256

# (filename, channel_index, internal_scale, default_value)
CHANNEL_FILES = [
    ("heightmap.tif", 0, 1.0, -1000.0),
    ("temperature.tif", 1, 1.0, None),
    ("temperature_std.tif", 2, 100.0, None),
    ("precipitation.tif", 3, 1.0, None),
    ("precipitation_cv.tif", 4, 1.0, None),
]


def _load_and_pad(path: Path, internal_scale: float, default_value):
    arr, transform, nodata = read_geotiff(path)
    arr = arr.astype(np.float32)
    if nodata is not None:
        arr = np.where(arr == nodata, np.nan, arr)
    fill = default_value if default_value is not None else 0.0
    arr = np.where(np.isfinite(arr), arr, fill)
    if internal_scale != 1.0:
        arr = arr * internal_scale
    return np.pad(arr, PADDING, mode="edge"), transform


def export(model_path, tiff_dir, output, snr="0.2,0.2,1.0,0.2,1.0", hdf5_file=None,
           cache_size="1G", seed=None, batch_size="1,2,4,8,16", dtype=None,
           caching_strategy="direct", chunk_size=8 * PIXELS_PER_CELL, device="cuda",
           **pipeline_kwargs):
    """Write the int16 elevation GeoTIFF and return its array."""
    tiff_dir = Path(tiff_dir)
    output = Path(output)
    output.parent.mkdir(parents=True, exist_ok=True)
    world = WorldPipeline.from_pretrained(
        model_path, seed=seed, latents_batch_size=parse_batch_sizes(str(batch_size)),
        dtype=dtype, caching_strategy=caching_strategy,
        cache_limit=parse_cache_size(cache_size), device=device, **pipeline_kwargs)

    if snr:
        snr_vals = [float(x.strip()) for x in str(snr).split(",")]
        if len(snr_vals) != 5:
            raise ValueError("--snr must have exactly 5 comma-separated values")
        world.set_cond_snr(snr_vals)

    if caching_strategy == "direct":
        world.bind(hdf5_file=hdf5_file)
    else:
        world.bind(hdf5_file or "TEMP")
    print(f"World seed: {world.seed}")

    ref_transform = None
    H_orig = W_orig = None
    for filename, channel, internal_scale, default_value in CHANNEL_FILES:
        path = tiff_dir / filename
        if not path.exists():
            print(f"  Skipping {filename} (not found). Perlin noise will be used instead.")
            continue
        padded, transform = _load_and_pad(path, internal_scale, default_value)
        if ref_transform is None:
            ref_transform = transform
            H_orig = padded.shape[0] - 2 * PADDING
            W_orig = padded.shape[1] - 2 * PADDING
        world.set_custom_conditioning_import(channel, padded, 0, 0,
                                             default_value=default_value)
        print(f"  Imported {filename} -> channel {channel}, padded {padded.shape}")

    if H_orig is None:
        raise ValueError("No conditioning TIFFs found in the directory.")

    out_h = H_orig * PIXELS_PER_CELL
    out_w = W_orig * PIXELS_PER_CELL
    out_transform = (ref_transform.scaled_pixels(PIXELS_PER_CELL)
                     if ref_transform is not None else None)
    print(f"Output: {output} ({out_w}x{out_h} px)")

    if chunk_size % PIXELS_PER_CELL != 0:
        raise ValueError(f"chunk_size must be a multiple of {PIXELS_PER_CELL}")
    chunk_cells = chunk_size // PIXELS_PER_CELL
    row_chunks = (H_orig + chunk_cells - 1) // chunk_cells
    col_chunks = (W_orig + chunk_cells - 1) // chunk_cells

    canvas = np.zeros((out_h, out_w), dtype=np.int16)
    with world:
        with tqdm(total=row_chunks * col_chunks, desc="Generating") as pbar:
            for ci in range(0, H_orig, chunk_cells):
                for cj in range(0, W_orig, chunk_cells):
                    ci2 = min(ci + chunk_cells, H_orig)
                    cj2 = min(cj + chunk_cells, W_orig)
                    pi1 = (PADDING + ci) * PIXELS_PER_CELL
                    pi2 = (PADDING + ci2) * PIXELS_PER_CELL
                    pj1 = (PADDING + cj) * PIXELS_PER_CELL
                    pj2 = (PADDING + cj2) * PIXELS_PER_CELL
                    result = world.get(pi1, pj1, pi2, pj2, with_climate=False)
                    elev = np.clip(result["elev"], -32768, 32767).astype(np.int16)
                    canvas[ci * PIXELS_PER_CELL:ci * PIXELS_PER_CELL + elev.shape[0],
                           cj * PIXELS_PER_CELL:cj * PIXELS_PER_CELL + elev.shape[1]] = elev
                    pbar.update(1)
    write_geotiff(output, canvas, out_transform)
    return canvas


@click.command()
@click.argument("model_path")
@click.argument("tiff_dir", type=click.Path(exists=True))
@click.argument("output", type=click.Path())
@click.option("--snr", metavar="ELEV,TEMP,T_STD,PRECIP,P_CV", default="0.2,0.2,1.0,0.2,1.0",
              help="Conditioning strength per channel (exactly 5 values)")
@click.option("--hdf5-file", default=None)
@click.option("--cache-size", default="1G")
@click.option("--seed", type=int, default=None)
@click.option("--batch-size", default="1,2,4,8,16")
@click.option("--dtype", type=click.Choice(["fp32", "bf16", "fp16"]), default="fp32")
@click.option("--caching-strategy", type=click.Choice(["indirect", "direct"]), default="direct")
@click.option("--chunk-size", type=int, default=8 * PIXELS_PER_CELL)
@click.option("--device", default="cuda", show_default=True,
              help="--device cpu runs on the CPU")
def main(model_path, tiff_dir, output, snr, hdf5_file, cache_size, seed, batch_size, dtype,
         caching_strategy, chunk_size, device):
    """Generate terrain from conditioning TIFFs and export to GeoTIFF."""
    click_check_device(device)
    return export(model_path, tiff_dir, output, snr=snr, hdf5_file=hdf5_file,
                  cache_size=cache_size, seed=seed, batch_size=batch_size,
                  dtype=None if dtype == "fp32" else dtype,
                  caching_strategy=caching_strategy, chunk_size=chunk_size, device=device)


if __name__ == "__main__":
    main()
