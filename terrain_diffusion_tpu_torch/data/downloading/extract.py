"""Extract equal-area grid cells from a global GeoTIFF (counterpart of
``terrain_diffusion_tpu.data.downloading.extract``): crops each grid cell's
window out of a mosaic raster and saves it as a per-cell TIFF, the input of
``build-base-dataset``.  Host numpy over the port's ``common/geotiff.py``.

``python -m terrain_diffusion_tpu_torch.data.downloading.extract TIFF OUT_DIR
[--cell-size-m M] [--prefix dem_] [--min-valid-pct P]``
"""
from __future__ import annotations

import os

import click
import numpy as np
from tqdm import tqdm

from terrain_diffusion_tpu_torch.common.geotiff import Affine, read_geotiff, write_geotiff
from terrain_diffusion_tpu_torch.data.world_grid import create_equal_area_grid


def extract_grid_data(tiff_path: str, grid_cells, output_dir: str,
                      prefix: str = "dem_", min_valid_pct: float = 0.0):
    """Write ``{prefix}{index}.tif`` for each of ``grid_cells`` ((min_lon,
    min_lat, max_lon, max_lat) boxes) that overlaps the raster and holds at
    least ``min_valid_pct`` of valid (not nodata) pixels."""
    os.makedirs(output_dir, exist_ok=True)
    arr, transform, nodata = read_geotiff(tiff_path)
    if transform is None:
        raise ValueError(f"{tiff_path} has no geotransform")
    written = 0
    for idx, (min_lon, min_lat, max_lon, max_lat) in enumerate(tqdm(grid_cells)):
        col0 = int((min_lon - transform.c) / transform.a)
        col1 = int(np.ceil((max_lon - transform.c) / transform.a))
        row0 = int((max_lat - transform.f) / transform.e)
        row1 = int(np.ceil((min_lat - transform.f) / transform.e))
        row0, row1 = sorted((max(row0, 0), min(row1, arr.shape[0])))
        col0, col1 = sorted((max(col0, 0), min(col1, arr.shape[1])))
        if row1 <= row0 or col1 <= col0:
            continue
        cell = arr[row0:row1, col0:col1]
        valid = cell if nodata is None else cell[cell != nodata]
        if min_valid_pct > 0 and valid.size / cell.size < min_valid_pct:
            continue
        cell_transform = Affine(
            transform.a, 0.0, transform.c + col0 * transform.a,
            0.0, transform.e, transform.f + row0 * transform.e)
        write_geotiff(os.path.join(output_dir, f"{prefix}{idx}.tif"),
                      np.asarray(cell), cell_transform, nodata=nodata)
        written += 1
    print(f"wrote {written} cells to {output_dir}")


@click.command()
@click.argument("tiff_path", type=click.Path(exists=True))
@click.argument("output_dir", type=click.Path())
@click.option("--cell-size-m", type=float, default=368640.0)
@click.option("--prefix", default="dem_")
@click.option("--min-valid-pct", type=float, default=0.0)
def main(tiff_path, output_dir, cell_size_m, prefix, min_valid_pct):
    """Extract equal-area grid cells from a global raster."""
    cells = create_equal_area_grid((cell_size_m, cell_size_m))
    extract_grid_data(tiff_path, cells, output_dir, prefix, min_valid_pct)


if __name__ == "__main__":
    main()
