"""Raw dataset builder (counterpart of
``terrain_diffusion_tpu.data.preprocessing.build_raw_dataset``): a folder of
elevation GeoTIFFs -> an HDF5 file of resized heightmaps.  Host only
(scipy); HDF5 needs ``h5py``.
"""
from __future__ import annotations

import glob
import os
import random

import click
import numpy as np
import scipy.ndimage as ndi
from tqdm import tqdm

from terrain_diffusion_tpu_torch.common.geotiff import read_geotiff


def _resize(arr: np.ndarray, size: int) -> np.ndarray:
    zoom = (size / arr.shape[0], size / arr.shape[1])
    return ndi.zoom(arr.astype(np.float32), zoom, order=1, grid_mode=True, mode="nearest")


@click.command()
@click.option("--elevation-folder", required=True)
@click.option("--output-size", type=int, default=2048)
@click.option("-o", "--output-file", default="raw_dataset.h5")
@click.option("--overwrite", is_flag=True)
@click.option("--limit", type=int, default=None)
@click.option("--seed", type=int, default=42)
def main(elevation_folder, output_size, output_file, overwrite, limit, seed):
    """Resize elevation TIFFs into an HDF5 of raw heightmaps."""
    import h5py

    files = sorted(glob.glob(os.path.join(elevation_folder, "*.tif")))
    random.Random(seed).shuffle(files)
    if limit:
        files = files[:limit]
    with h5py.File(output_file, "a") as f:
        for path in tqdm(files):
            name = os.path.splitext(os.path.basename(path))[0]
            if name in f:
                if not overwrite:
                    continue
                del f[name]
            arr, _, nodata = read_geotiff(path)
            arr = arr.astype(np.float32)
            if nodata is not None:
                arr = np.where(arr == nodata, np.nan, arr)
            arr = np.nan_to_num(arr, nan=float(np.nanmedian(arr)))
            f.create_dataset(name, data=_resize(arr, output_size), compression="lzf")
    print(f"wrote {len(files)} rasters to {output_file}")


if __name__ == "__main__":
    main()
