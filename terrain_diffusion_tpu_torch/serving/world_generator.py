"""Batch world pre-generation, the ``generate`` command (counterpart of
``terrain_diffusion_tpu.serving.world_generator``).

Walks ``world.residual`` slices over a coarse window in 2048-px tiles, so
every stage window there lands in the tile store (with ``--caching-strategy
indirect``, in the HDF5 world file).  Each slice runs the decoder stage,
whose residual blocks and convs take the CUDA kernels on the card.

Run:
    python -m terrain_diffusion_tpu_torch generate <world_dir> \\
        --caching-strategy indirect --hdf5-file world.h5
"""
from __future__ import annotations

import click
from tqdm import tqdm

from terrain_diffusion_tpu_torch.common.cli_helpers import (click_check_device,
                                                           parse_batch_sizes,
                                                           parse_cache_size, parse_kwargs)
from terrain_diffusion_tpu_torch.pipeline.world import WorldPipeline


def generate_world(model_path: str, hdf5_file=None, seed=None, coarse_window: int = 64,
                   caching_strategy: str = "direct", tile_size: int = 2048,
                   device="cuda", **kwargs) -> dict:
    """Generate the residual over [-coarse_window, coarse_window)^2 coarse
    cells (256 px each); returns the seed, the decoder windows the walk
    covers and the decoder batches it ran."""
    if tile_size < 256 or tile_size % 256:
        # the walk strides in coarse cells (256 px): a smaller tile would
        # leave gaps that are never generated
        raise ValueError(f"tile_size must be a positive multiple of 256, got {tile_size}")
    world = WorldPipeline.from_pretrained(model_path, seed=seed,
                                          caching_strategy=caching_strategy,
                                          device=device, **kwargs)
    if caching_strategy == "direct":
        world.bind(hdf5_file=hdf5_file)
    else:
        world.bind(hdf5_file or "TEMP")
    with world:
        print(f"World seed: {world.seed}")
        ci0, ci1 = -coarse_window, coarse_window
        cj0, cj1 = -coarse_window, coarse_window
        step = tile_size // 256  # the loop unit is the coarse cell (256 px)
        pbar = tqdm(total=((ci1 - ci0 + step - 1) // step) * ((cj1 - cj0 + step - 1) // step),
                    desc="Generating world")
        windows = set()
        for i in range(ci0, ci1, step):
            for j in range(cj0, cj1, step):
                ranges = [(0, 2), (i * 256, i * 256 + tile_size), (j * 256, j * 256 + tile_size)]
                world.residual[:, ranges[1][0]:ranges[1][1], ranges[2][0]:ranges[2][1]]
                windows |= set(world.residual.output_window.windows_overlapping(ranges))
                pbar.update(1)
        pbar.close()
        return {"seed": world.seed, "decoder_windows": len(windows),
                "decoder_batches": world.timing_summary().get("decoder", {}).get("calls", 0)}


@click.command()
@click.argument("model_path")
@click.option("--caching-strategy", type=click.Choice(["indirect", "direct"]), default="direct")
@click.option("--hdf5-file", default=None)
@click.option("--cache-size", default="100M")
@click.option("--seed", type=int, default=None)
@click.option("--batch-size", type=str, default="1,2,4,8,16")
@click.option("--log-mode", type=click.Choice(["info", "verbose"]), default="verbose")
@click.option("--coarse-window", type=int, default=50)
@click.option("--dtype", type=click.Choice(["fp32", "bf16", "fp16"]), default="fp32")
@click.option("--device", default="cuda", show_default=True,
              help="--device cpu runs on the CPU")
@click.option("--kwarg", "extra_kwargs", multiple=True)
def main(model_path, caching_strategy, hdf5_file, cache_size, seed, batch_size,
         log_mode, coarse_window, dtype, device, extra_kwargs):
    """Generate a world using the terrain diffusion pipeline (indirect caching
    without --hdf5-file writes a temporary world file, removed at the end)."""
    click_check_device(device)
    return generate_world(
        model_path, hdf5_file, seed=seed, coarse_window=coarse_window,
        latents_batch_size=parse_batch_sizes(batch_size), log_mode=log_mode,
        dtype=None if dtype == "fp32" else dtype, caching_strategy=caching_strategy,
        cache_limit=parse_cache_size(cache_size), device=device,
        **parse_kwargs(extra_kwargs))


if __name__ == "__main__":
    main()
