"""Per-cell elevation preprocessing (counterpart of
``terrain_diffusion_tpu.data.preprocessing.elevation``):

read a MERIT / Copernicus DEM cell and the ETOPO low-resolution context,
void-fill with distance feathering toward the low-resolution field,
signed-sqrt transform, Laplacian encode into (residual, lowfreq) on the
device, block-median ``lowres_exact``, 19 WorldClim bio layers, and split
into subchunks with ``pct_land``.

The Laplacian encode of the full-resolution DEM runs on ``device``
(``ops/laplacian.py``); reading, void-filling, resizing and the block median
stay on the host (the package's GeoTIFF reader and scipy), as in JAX.
"""
from __future__ import annotations

import os

import numpy as np
import scipy.ndimage as ndi
import torch

from terrain_diffusion_tpu_torch.common.geotiff import read_geotiff
from terrain_diffusion_tpu_torch.ops.laplacian import laplacian_encode


def _resize(arr: np.ndarray, size: tuple[int, int], order: int = 1) -> np.ndarray:
    zoom = (size[0] / arr.shape[0], size[1] / arr.shape[1])
    return ndi.zoom(arr, zoom, order=order, grid_mode=True, mode="nearest")


def _block_median(arr: np.ndarray, k: int) -> np.ndarray:
    h, w = arr.shape
    return np.median(arr[: h // k * k, : w // k * k]
                     .reshape(h // k, k, w // k, k), axis=(1, 3))


def extract_window(path: str, bounds) -> np.ndarray | None:
    """Crop a global raster to (min_lon, min_lat, max_lon, max_lat)."""
    arr, transform, nodata = read_geotiff(path)
    if transform is None:
        return None
    min_lon, min_lat, max_lon, max_lat = bounds
    col0 = int((min_lon - transform.c) / transform.a)
    col1 = int(np.ceil((max_lon - transform.c) / transform.a))
    row0 = int((max_lat - transform.f) / transform.e)
    row1 = int(np.ceil((min_lat - transform.f) / transform.e))
    row0, row1 = sorted((row0, row1))
    col0, col1 = sorted((col0, col1))
    # clamp both ends: a negative slice end would wrap and select a wrong window
    row0, col0 = max(row0, 0), max(col0, 0)
    row1 = min(max(row1, 0), arr.shape[0])
    col1 = min(max(col1, 0), arr.shape[1])
    out = arr[row0:row1, col0:col1].astype(np.float32)
    if nodata is not None:
        out[out == nodata] = np.nan
    return out


def process_single_cell(
    chunk_id: str,
    bounds,
    highres_elevation_folder: str,
    lowres_elevation_file: str,
    highres_size: int,
    lowres_size: int,
    lowres_sigma: float,
    num_chunks: int = 1,
    climate_folder: str | None = None,
    edge_margin: int = 0,
    data_source: str = "merit",
    *,
    device="cuda",
) -> list[dict]:
    """The subchunks of one grid cell: residual, lowfreq, climate,
    lowres_exact, pct_land and their ids."""
    if highres_size % lowres_size:
        raise ValueError(f"highres_size {highres_size} is not a multiple of "
                         f"lowres_size {lowres_size}")
    prefix = "dem_" if data_source == "merit" else "copernicus_"
    highres_margin = edge_margin * highres_size // lowres_size
    path = os.path.join(highres_elevation_folder, prefix + chunk_id + ".tif")

    if os.path.exists(path):
        dem, _, nodata = read_geotiff(path)
        dem = dem.astype(np.float32)
        if data_source == "merit":
            dem = np.where(dem < -1000, np.nan, dem)
        else:
            dem = np.where(dem == 0.0, np.nan, dem)
        if not np.isnan(dem).all():
            dem = _resize_nan(dem, (highres_size, highres_size))
        else:
            dem = np.full((highres_size, highres_size), np.nan, np.float32)
    else:
        dem = np.full((highres_size, highres_size), np.nan, np.float32)
    if highres_margin > 0:
        dem = dem[highres_margin:-highres_margin, highres_margin:-highres_margin]

    low = extract_window(lowres_elevation_file, bounds)
    low = np.where(low > -1, -1.0, low).astype(np.float32)
    low = _resize(np.nan_to_num(low, nan=-1.0), (lowres_size, lowres_size))
    low = ndi.gaussian_filter(low, sigma=lowres_sigma)
    low_up = _resize(low, (highres_size, highres_size))
    if highres_margin > 0:
        low_up = low_up[highres_margin:-highres_margin, highres_margin:-highres_margin]

    if np.isnan(dem).all():
        dem = low_up
    elif np.isnan(dem).any():
        nan_mask = np.isnan(dem)
        distance = ndi.distance_transform_edt(nan_mask)
        alpha = np.minimum(1, distance[nan_mask] / 32)
        dem[nan_mask] = low_up[nan_mask] * alpha

    climate = None
    if climate_folder is not None:
        layers = []
        for i in range(1, 20):
            fp = os.path.join(climate_folder, f"wc2.1_30s_bio_{i}.tif")
            c = extract_window(fp, bounds)
            if c is None or np.isnan(c).all():
                c = np.full((lowres_size, lowres_size), np.nan, np.float32)
            else:
                c = _resize(np.nan_to_num(c, nan=np.nanmean(c)),
                            (lowres_size, lowres_size), order=0)
            layers.append(c)
        climate = np.stack(layers, axis=0)
        if edge_margin > 0:
            climate = climate[..., edge_margin:-edge_margin, edge_margin:-edge_margin]

    ratio = highres_size // lowres_size
    dem = np.sign(dem) * np.sqrt(np.abs(dem))
    lowres_exact = _block_median(dem, ratio)
    x = torch.from_numpy(np.ascontiguousarray(dem, np.float32)).to(device)[None]
    with torch.no_grad():
        residual, lowfreq = laplacian_encode(x, lowres_size - edge_margin * 2, lowres_sigma)
    residual, lowfreq = residual[0].cpu().numpy(), lowfreq[0].cpu().numpy()

    hcs = (highres_size - highres_margin * 2) // num_chunks
    lcs = (lowres_size - edge_margin * 2) // num_chunks
    out = []
    for ch in range(num_chunks):
        for cw in range(num_chunks):
            h0, w0 = ch * hcs, cw * hcs
            l0, l1 = ch * lcs, cw * lcs
            lf = lowfreq[l0:l0 + lcs, l1:l1 + lcs]
            out.append({
                "residual": residual[h0:h0 + hcs, w0:w0 + hcs],
                "lowfreq": lf,
                "climate": (climate[:, l0:l0 + lcs, l1:l1 + lcs]
                            if climate is not None else None),
                "lowres_exact": lowres_exact[l0:l0 + lcs, l1:l1 + lcs],
                "pct_land": float((lf > 0).mean()),
                "chunk_id": chunk_id,
                "subchunk_id": f"chunk_{ch}_{cw}",
            })
    return out


def _resize_nan(arr: np.ndarray, size) -> np.ndarray:
    """NaN-preserving bilinear resize: interpolates valid values, keeps a
    resized NaN mask."""
    mask = np.isnan(arr)
    filled = np.where(mask, 0.0, arr)
    w = _resize((~mask).astype(np.float32), size)
    v = _resize(filled, size)
    out = np.where(w > 0.5, v / np.maximum(w, 1e-6), np.nan)
    return out.astype(np.float32)


def _window_indices(transform, xs_min, ys_min, xs_max, ys_max, shape,
                    pad: int = 1):
    """Pixel window [row0:row1, col0:col1] covering a projected bbox."""
    cols = [(xs_min - transform.c) / transform.a,
            (xs_max - transform.c) / transform.a]
    rows = [(ys_min - transform.f) / transform.e,
            (ys_max - transform.f) / transform.e]
    col0 = max(int(np.floor(min(cols))) - pad, 0)
    col1 = min(int(np.ceil(max(cols))) + pad, shape[1])
    row0 = max(int(np.floor(min(rows))) - pad, 0)
    row1 = min(int(np.ceil(max(rows))) + pad, shape[0])
    return row0, row1, col0, col1


def _sample_to_wgs84_grid(arr, transform, crs, bounds, out_shape,
                          nodata=None):
    """Inverse-warp bilinear resample of a (possibly projected) raster onto
    a regular EPSG:4326 grid over ``bounds``."""
    lon_min, lat_min, lon_max, lat_max = bounds
    h, w = out_shape
    lons = lon_min + (np.arange(w) + 0.5) * (lon_max - lon_min) / w
    lats = lat_max - (np.arange(h) + 0.5) * (lat_max - lat_min) / h
    lon_g, lat_g = np.meshgrid(lons, lats)
    x, y = crs.from_wgs84(lon_g, lat_g)
    col = (x - transform.c) / transform.a - 0.5
    row = (y - transform.f) / transform.e - 0.5
    src = np.asarray(arr, np.float32)
    if nodata is not None:
        src = np.where(src == np.float32(nodata), np.nan, src)
    out = ndi.map_coordinates(src, [row, col], order=1, mode="constant",
                              cval=np.nan)
    return out.astype(np.float32)


def extract_mask_from_tiffs(tiff_path, bounds):
    """Raster data over WGS84 ``bounds`` with automatic CRS handling: read
    the window that intersects ``bounds`` and, when the source CRS is
    projected, inverse-warp it bilinearly onto a regular EPSG:4326 grid.

    Supported CRSes are those of ``common/crs.py`` (4326, 3857, WGS84 UTM,
    3031, 3413); a file with no CRS keys is taken as EPSG:4326.

    Args:
        tiff_path: a GeoTIFF file, or a directory of GeoTIFFs (a mosaic: the
            intersecting files share one CRS; earlier files win where they
            overlap).
        bounds: (lon_min, lat_min, lon_max, lat_max) in WGS84 degrees.

    Returns:
        float32 array on the EPSG:4326 grid; nodata and uncovered cells are
        NaN.  Its size follows the source window's pixel count.
    """
    from pathlib import Path

    from terrain_diffusion_tpu_torch.common.crs import CRS
    from terrain_diffusion_tpu_torch.common.geotiff import read_geotiff_info

    path = Path(tiff_path)
    lon_min, lat_min, lon_max, lat_max = (float(b) for b in bounds)

    def load(p):
        arr, transform, nodata, crs_str = read_geotiff_info(p)
        if transform is None:
            raise ValueError(f"{p} has no geotransform")
        return arr, transform, nodata, CRS(crs_str or "EPSG:4326")

    def window(arr, transform, crs):
        if crs.is_geographic:
            bx0, by0, bx1, by1 = lon_min, lat_min, lon_max, lat_max
        else:
            bx0, by0, bx1, by1 = crs.transform_bounds(lon_min, lat_min, lon_max, lat_max)
        return _window_indices(transform, bx0, by0, bx1, by1, arr.shape)

    if path.is_file():
        arr, transform, nodata, crs = load(path)
        r0, r1, c0, c1 = window(arr, transform, crs)
        if r1 <= r0 or c1 <= c0:
            raise ValueError(f"{path} does not intersect bounds {bounds}")
        if crs.is_geographic:
            out = arr[r0:r1, c0:c1].astype(np.float32)
            if nodata is not None:
                out[out == np.float32(nodata)] = np.nan
            if out.dtype == np.float32:
                out[np.abs(out) > 1e10] = np.nan
            return out
        return _sample_to_wgs84_grid(arr, transform, crs, bounds,
                                     (r1 - r0, c1 - c0), nodata)

    if path.is_dir():
        files = sorted(path.glob("*.tif")) + sorted(path.glob("*.tiff"))
        picked = []
        for p in files:
            arr, transform, nodata, crs = load(p)
            r0, r1, c0, c1 = window(arr, transform, crs)
            if r1 > r0 and c1 > c0:
                picked.append((arr, transform, nodata, crs, (r1 - r0, c1 - c0)))
        if not picked:
            raise ValueError(f"No TIFF files intersect bounds {bounds} in {tiff_path}")
        crs0 = picked[0][3]
        if any(c.epsg != crs0.epsg for _, _, _, c, _ in picked):
            raise ValueError("mosaic inputs must share one CRS")
        out_shape = max((ws for *_, ws in picked), key=lambda s: s[0] * s[1])
        out = None
        for arr, transform, nodata, crs, _ in picked:
            part = _sample_to_wgs84_grid(arr, transform, crs, bounds, out_shape, nodata)
            out = part if out is None else np.where(np.isnan(out), part, out)
        return out

    raise ValueError(f"not a TIFF file or directory: {tiff_path}")
