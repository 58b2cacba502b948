"""Land-biased random tile sampling and relief imagery (counterpart of
``terrain_diffusion_tpu.serving.random_sampler``).

Each tile is a ``world.get``, whose decoder stage runs the CUDA kernels on
the card.

Run:
    python -m terrain_diffusion_tpu_torch.serving.random_sampler <world_dir> <out_dir>
"""
from __future__ import annotations

import os

import click
import numpy as np

from terrain_diffusion_tpu_torch.common.cli_helpers import (click_check_device,
                                                           parse_batch_sizes,
                                                           parse_cache_size, parse_kwargs)
from terrain_diffusion_tpu_torch.serving.relief_map import get_relief_map


def sample_random_tiles(world, n: int = 4, tile: int = 512, seed: int = 0,
                        land_bias_tries: int = 8, separation: int = 200 * 256):
    """Yield (center, region) dicts at random far-apart locations, preferring
    tiles with land (coarse-channel screening before full generation).

    `separation` is enforced as a minimum center distance between yielded
    tiles; the candidate range scales with n and separation so the promise
    is actually satisfiable."""
    rng = np.random.default_rng(seed)
    sep_cells = max(-(-int(separation) // 256), 1)
    span = max(30, 2 * sep_cells * max(n, 1))
    chosen: list[tuple[int, int]] = []

    def far_enough(ci, cj):
        return all(max(abs(ci - a), abs(cj - b)) >= sep_cells
                   for a, b in chosen)

    for _ in range(n):
        best = None
        for _ in range(land_bias_tries):
            ci = int(rng.integers(-span, span))
            cj = int(rng.integers(-span, span))
            if not far_enough(ci, cj):
                continue
            coarse = world.coarse[:, ci:ci + 2, cj:cj + 2]
            elev_ss = (coarse[0] / np.maximum(coarse[-1], 1e-6)).mean()
            if best is None or elev_ss > best[0]:
                best = (float(elev_ss), ci, cj)
            if elev_ss > 0:
                break
        if best is None:  # every candidate was too close: take any far cell
            while True:
                ci = int(rng.integers(-span, span))
                cj = int(rng.integers(-span, span))
                if far_enough(ci, cj):
                    best = (0.0, ci, cj)
                    break
        _, ci, cj = best
        chosen.append((ci, cj))
        center_i, center_j = ci * 256, cj * 256
        half = tile // 2
        region = world.get(center_i - half, center_j - half,
                           center_i + half, center_j + half)
        yield {"center": (center_i, center_j), **region}


@click.command()
@click.argument("model_path")
@click.argument("out_dir", type=click.Path())
@click.option("--n", type=int, default=4)
@click.option("--tile", type=int, default=512)
@click.option("--seed", type=int, default=0)
@click.option("--batch-size", default="1,2,4,8,16")
@click.option("--dtype", type=click.Choice(["fp32", "bf16", "fp16"]), default="bf16")
@click.option("--cache-size", default="1G")
@click.option("--device", default="cuda", show_default=True,
              help="--device cpu runs on the CPU")
@click.option("--kwarg", "extra_kwargs", multiple=True)
def main(model_path, out_dir, n, tile, seed, batch_size, dtype, cache_size, device,
         extra_kwargs):
    """Render random terrain tiles (relief PNGs); returns the tiles."""
    from PIL import Image

    from terrain_diffusion_tpu_torch.pipeline.world import WorldPipeline

    click_check_device(device)
    os.makedirs(out_dir, exist_ok=True)
    world = WorldPipeline.from_pretrained(
        model_path, seed=seed, latents_batch_size=parse_batch_sizes(batch_size),
        dtype=None if dtype == "fp32" else dtype,
        cache_limit=parse_cache_size(cache_size), device=device,
        **parse_kwargs(extra_kwargs))
    world.bind()
    tiles = []
    with world:
        for k, item in enumerate(sample_random_tiles(world, n=n, tile=tile, seed=seed)):
            relief = get_relief_map(item["elev"], None, None, None,
                                    resolution=world.native_resolution)
            img = (np.clip(relief, 0, 1) * 255).astype(np.uint8)
            ci, cj = item["center"]
            Image.fromarray(img).save(os.path.join(out_dir, f"tile_{k}_{ci}_{cj}.png"))
            print(f"tile {k} at ({ci},{cj}): elev [{item['elev'].min():.0f}, "
                  f"{item['elev'].max():.0f}] m")
            tiles.append(item)
    return tiles


if __name__ == "__main__":
    main()
