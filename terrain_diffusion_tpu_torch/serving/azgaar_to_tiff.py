"""Azgaar Fantasy Map Builder JSON -> conditioning GeoTIFF rasters, the
``azgaar-to-tiff`` command (counterpart of
``terrain_diffusion_tpu.serving.azgaar_to_tiff``; host only, no device work):
polygon-rasterizes grid/pack cells, converts Azgaar heights to meters via the
(h-18)^exponent land curve and a power-law ocean curve, derives temperature
std / precipitation CV from biome, nearest-fills nodata, and writes five
GeoTIFFs sized by latitude-aware km/px.  Output feeds ``tiff-export``.
"""
from __future__ import annotations

import json
from pathlib import Path

import click
import numpy as np
from scipy.ndimage import distance_transform_edt

from terrain_diffusion_tpu_torch.common.geotiff import Affine, rasterize_polygons, write_geotiff

# Biome ID -> (temp_std_C, precip_cv_pct); means come from grid cell data.
BIOME_VARIABILITY = {
    0: (float("nan"), float("nan")),  # Marine
    1: (5.0, 80.0),    # Hot Desert
    2: (15.0, 33.0),   # Cold Desert
    3: (5.0, 28.6),    # Savanna
    4: (10.0, 25.0),   # Grassland
    5: (3.0, 26.7),    # Tropical Seasonal Forest
    6: (8.0, 22.2),    # Temperate Deciduous Forest
    7: (2.0, 16.0),    # Tropical Rainforest
    8: (6.0, 25.0),    # Temperate Rainforest
    9: (15.0, 20.0),   # Taiga
    10: (15.0, 25.0),  # Tundra
    11: (10.0, 30.0),  # Glacier
    12: (8.0, 20.0),   # Wetland
}
TEMP_STD_IDX, PRECIP_CV_IDX = 0, 1


def load_map(path):
    with open(path) as f:
        data = json.load(f)
    info = data["info"]
    coords = data["mapCoordinates"]
    pack = data["pack"]
    grid = data["grid"]
    pack_verts = {v["i"]: v["p"] for v in pack["vertices"]}
    grid_verts = {v["i"]: v["p"] for v in grid["vertices"]}
    height_exponent = float(data["settings"]["heightExponent"])
    return (info["width"], info["height"], coords, pack["cells"], pack_verts,
            grid["cells"], grid_verts, height_exponent)


def h_to_meters(h, exponent, ocean_max_depth=4000.0, ocean_power=1.5):
    """Azgaar internal height (0-100) to meters; land matches Azgaar's
    getHeight() (h-18)^exponent, ocean is a power depth curve."""
    if h < 20:
        return -ocean_max_depth * ((20 - h) / 20) ** ocean_power
    return float(h - 18) ** exponent


def _shapes(cells, verts, scale_x, scale_y, value_fn):
    for cell in cells:
        value = value_fn(cell)
        if value is None or (isinstance(value, float) and np.isnan(value)):
            continue
        try:
            ring = [(px * scale_x, py * scale_y)
                    for px, py in (verts[vi] for vi in cell["v"])]
        except KeyError:
            continue
        yield ring, value


def rasterize_layer(cells, verts, scale_x, scale_y, shape, value_fn, fill):
    return rasterize_polygons(
        _shapes(cells, verts, scale_x, scale_y, value_fn), shape, fill=fill)


def fill_nodata(arr, nodata):
    """Nearest-valid fill of nodata pixels."""
    if isinstance(nodata, float) and np.isnan(nodata):
        mask = np.isnan(arr)
    else:
        mask = arr == nodata
    if not mask.any():
        return arr
    indices = distance_transform_edt(mask, return_distances=False,
                                     return_indices=True)
    return arr[tuple(indices)]


def convert(input_path, output_dir, scale=100.0, ocean_max_depth=4000.0,
            ocean_power=1.5) -> dict:
    input_path = Path(input_path)
    output_dir = Path(output_dir)
    output_dir.mkdir(parents=True, exist_ok=True)

    (map_w, map_h, coords, pack_cells, pack_verts, grid_cells, grid_verts,
     height_exponent) = load_map(input_path)
    lon_w, lon_e = coords["lonW"], coords["lonE"]
    lat_s, lat_n = coords["latS"], coords["latN"]
    mid_lat = np.radians((lat_n + lat_s) / 2)
    km_per_deg_lat = 111.32
    km_per_deg_lon = 111.32 * np.cos(mid_lat)
    out_w = max(1, round((lon_e - lon_w) * km_per_deg_lon / scale))
    out_h = max(1, round((lat_n - lat_s) * km_per_deg_lat / scale))
    scale_x, scale_y = out_w / map_w, out_h / map_h
    transform = Affine.from_bounds(lon_w, lat_s, lon_e, lat_n, out_w, out_h)
    shape = (out_h, out_w)

    grid_kw = dict(cells=grid_cells, verts=grid_verts, scale_x=scale_x,
                   scale_y=scale_y, shape=shape)
    pack_kw = dict(cells=pack_cells, verts=pack_verts, scale_x=scale_x,
                   scale_y=scale_y, shape=shape)
    out = {}

    arr = rasterize_layer(**grid_kw, fill=np.nan, value_fn=lambda c: h_to_meters(
        c.get("h", 0), height_exponent, ocean_max_depth, ocean_power))
    arr = fill_nodata(arr, np.nan)
    write_geotiff(output_dir / "heightmap.tif", arr, transform)
    out["heightmap"] = arr

    arr = rasterize_layer(**grid_kw, fill=-9999.0,
                          value_fn=lambda c: float(c["temp"]) if "temp" in c else None)
    arr = fill_nodata(arr, -9999.0)
    write_geotiff(output_dir / "temperature.tif", arr, transform)
    out["temperature"] = arr

    arr = rasterize_layer(**pack_kw, fill=-9999.0, value_fn=lambda c:
                          BIOME_VARIABILITY.get(c.get("biome", 0),
                                                (np.nan, np.nan))[TEMP_STD_IDX])
    arr = fill_nodata(arr, -9999.0)
    write_geotiff(output_dir / "temperature_std.tif", arr, transform)
    out["temperature_std"] = arr

    arr = rasterize_layer(**grid_kw, fill=-9999.0, value_fn=lambda c:
                          float(c["prec"]) * 100.0 if "prec" in c else None)
    arr = fill_nodata(arr, -9999.0)
    write_geotiff(output_dir / "precipitation.tif", arr, transform)
    out["precipitation"] = arr

    arr = rasterize_layer(**pack_kw, fill=-9999.0, value_fn=lambda c:
                          BIOME_VARIABILITY.get(c.get("biome", 0),
                                                (np.nan, np.nan))[PRECIP_CV_IDX])
    arr = fill_nodata(arr, -9999.0)
    write_geotiff(output_dir / "precipitation_cv.tif", arr, transform)
    out["precipitation_cv"] = arr
    return out


@click.command()
@click.argument("input", type=click.Path(exists=True))
@click.argument("output_dir", type=click.Path())
@click.option("--scale", default=100.0, show_default=True,
              help="Size of each output pixel in km")
@click.option("--ocean-max-depth", default=4000.0, show_default=True)
@click.option("--ocean-power", default=1.5, show_default=True)
def main(input, output_dir, scale, ocean_max_depth, ocean_power):
    """Convert an Azgaar full JSON export to GeoTIFF rasters."""
    print(f"Reading {input}...")
    convert(input, output_dir, scale, ocean_max_depth, ocean_power)
    print(f"Wrote TIFFs to {output_dir}/")


if __name__ == "__main__":
    main()
