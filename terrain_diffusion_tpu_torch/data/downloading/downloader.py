"""Earth Engine DEM downloader (counterpart of
``terrain_diffusion_tpu.data.downloading.downloader``): MERIT 90 m or
Copernicus GLO-30 per equal-area cell through the Earth Engine high-volume
API, on a thread pool, with retries, a temporary file renamed into place
(``os.replace``) and the clean-up of a partial file, and an optional
land-fraction filter.

It needs the ``earthengine-api`` package and authenticated credentials;
without ``ee`` it raises an ``ImportError`` that names the package.  An
offline acquisition tool, not a serving dependency.

``python -m terrain_diffusion_tpu_torch.data.downloading.downloader OUT_DIR
[--dataset merit|copernicus] [--cell-size-m M] [--min-land F]
[--num-workers N] [--limit N]``
"""
from __future__ import annotations

import concurrent.futures as cf
import os
import tempfile
import time

import click
import numpy as np

from terrain_diffusion_tpu_torch.data.world_grid import create_equal_area_grid

DATASETS = {  # name -> (Earth Engine asset, band, scale in meters)
    "merit": ("MERIT/DEM/v1_0_3", "dem", 90),
    "copernicus": ("COPERNICUS/DEM/GLO30", "DEM", 30),
}


def _require_ee():
    try:
        import ee  # noqa: F401

        return ee
    except ImportError as e:
        raise ImportError(
            "earthengine-api is required for DEM downloads: pip install "
            "earthengine-api and authenticate (ee.Authenticate()).") from e


def _land_fraction(bounds) -> float:
    """Approximate land fraction of a cell (``global_land_mask`` if
    available, else 1.0, which keeps every cell)."""
    try:
        from global_land_mask import globe
    except ImportError:
        return 1.0
    min_lon, min_lat, max_lon, max_lat = bounds
    lats = np.linspace(min_lat, max_lat, 8)
    lons = np.linspace(min_lon, max_lon, 8)
    gl, gn = np.meshgrid(lats, lons)
    return float(globe.is_land(gl, gn).mean())


def download_cell(ee, dataset: str, cell_id: str, bounds, out_folder: str,
                  scale: int, retries: int = 5) -> bool:
    """Download one cell to ``out_folder/{dem_|copernicus_}{cell_id}.tif``;
    True once the file is there (an existing file counts), False after
    ``retries`` failed attempts, which leave no partial file behind."""
    import urllib.request

    asset, band, _ = DATASETS[dataset]
    prefix = "dem_" if dataset == "merit" else "copernicus_"
    out_path = os.path.join(out_folder, f"{prefix}{cell_id}.tif")
    if os.path.exists(out_path):
        return True
    region = ee.Geometry.Rectangle(list(bounds))
    img = ee.Image(asset).select(band)
    for attempt in range(retries):
        tmp = None
        try:
            url = img.getDownloadURL({
                "region": region, "scale": scale, "format": "GEO_TIFF"})
            fd, tmp = tempfile.mkstemp(suffix=".tif", dir=out_folder)
            os.close(fd)
            urllib.request.urlretrieve(url, tmp)
            os.replace(tmp, out_path)  # atomic
            return True
        except Exception as e:  # noqa: BLE001 - the retry loop
            if tmp is not None:  # a leaked partial .tif would be globbed
                try:             # up as data when the dataset is built
                    os.unlink(tmp)
                except OSError:
                    pass
            print(f"cell {cell_id} attempt {attempt + 1} failed: {e}")
            time.sleep(2.0 * (attempt + 1))
    return False


def download_dem(out_folder: str, dataset: str = "merit",
                 cell_size_m: float = 368640.0, min_land: float = 0.0,
                 num_workers: int = 8, limit: int | None = None):
    """Download every equal-area cell of ``cell_size_m`` (with a land
    fraction of at least ``min_land``; the first ``limit``) on
    ``num_workers`` threads."""
    ee = _require_ee()
    ee.Initialize(opt_url="https://earthengine-highvolume.googleapis.com")
    os.makedirs(out_folder, exist_ok=True)
    _, _, scale = DATASETS[dataset]
    cells = create_equal_area_grid((cell_size_m, cell_size_m))
    jobs = []
    for i, bounds in enumerate(cells):
        if min_land > 0 and _land_fraction(bounds) < min_land:
            continue
        jobs.append((str(i), bounds))
        if limit and len(jobs) >= limit:
            break
    print(f"{len(jobs)} cells to download")
    ok = 0
    with cf.ThreadPoolExecutor(num_workers) as ex:
        futs = [ex.submit(download_cell, ee, dataset, cid, b, out_folder, scale)
                for cid, b in jobs]
        for f in cf.as_completed(futs):
            ok += bool(f.result())
    print(f"downloaded {ok}/{len(jobs)} cells")


@click.command()
@click.argument("out_folder", type=click.Path())
@click.option("--dataset", type=click.Choice(list(DATASETS)), default="merit")
@click.option("--cell-size-m", type=float, default=368640.0)
@click.option("--min-land", type=float, default=0.0)
@click.option("--num-workers", type=int, default=8)
@click.option("--limit", type=int, default=None)
def main(out_folder, dataset, cell_size_m, min_land, num_workers, limit):
    """Download DEM cells from Earth Engine."""
    download_dem(out_folder, dataset, cell_size_m, min_land, num_workers, limit)


if __name__ == "__main__":
    main()
