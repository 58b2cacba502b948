"""Streaming statistics commands (counterpart of
``terrain_diffusion_tpu.data.calculate_stats``): Welford mean / std over the
datasets of an HDF5 file or over a folder of rasters.  Host only; ``h5``
needs ``h5py``.

    python -m terrain_diffusion_tpu_torch.data.calculate_stats h5 FILE [--dataset residual]
    python -m terrain_diffusion_tpu_torch.data.calculate_stats rasters FOLDER [--signed-sqrt]
"""
from __future__ import annotations

import glob
import os

import click
import numpy as np

from terrain_diffusion_tpu_torch.data.welford import Welford


@click.group()
def cli():
    """Dataset statistics tools."""


@cli.command("h5")
@click.argument("h5_file", type=click.Path(exists=True))
@click.option("--dataset", "dataset_name", default="residual")
@click.option("--resolution", default=None)
def h5_stats(h5_file, dataset_name, resolution):
    """Per-dataset mean/std over every `{res}/{chunk}/{subchunk}/<dataset>`."""
    import h5py

    w = Welford(1)
    with h5py.File(h5_file, "r") as f:
        res_keys = [resolution] if resolution else list(f.keys())
        for rk in res_keys:
            for cid in f[rk]:
                for sub in f[rk][cid]:
                    g = f[rk][cid][sub]
                    if dataset_name in g:
                        w.update(np.asarray(g[dataset_name], np.float64)[None])
    print(f"{dataset_name}: mean={w.mean[0]:.6f} std={w.std[0]:.6f} "
          f"n={int(w.count[0])}")


@cli.command("rasters")
@click.argument("folder", type=click.Path(exists=True))
@click.option("--pattern", default="*.tif")
@click.option("--signed-sqrt", is_flag=True)
def raster_stats(folder, pattern, signed_sqrt):
    """Mean/std over a folder of rasters (NaN-aware)."""
    from terrain_diffusion_tpu_torch.common.geotiff import read_geotiff

    w = Welford(1)
    for path in sorted(glob.glob(os.path.join(folder, pattern))):
        arr, _, nodata = read_geotiff(path)
        arr = arr.astype(np.float64)
        if nodata is not None:
            arr[arr == nodata] = np.nan
        if signed_sqrt:
            arr = np.sign(arr) * np.sqrt(np.abs(arr))
        w.update(arr[None])
    print(f"mean={w.mean[0]:.6f} std={w.std[0]:.6f} n={int(w.count[0])}")


if __name__ == "__main__":
    cli()
