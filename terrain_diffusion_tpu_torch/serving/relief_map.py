"""Shaded relief rendering (explorer + evaluation imagery).

Counterpart of ``terrain_diffusion_tpu.serving.relief_map``: the same numpy and
scipy code, kept as the port's own copy.

Feature-parity rebuild of reference `inference/relief_map.py:64-204`:
multi-scale GDAL-style hillshade, elevation colormap with sea-level-aware
range mapping, optional Koppen biome palette, river overlay from flow
accumulation, and depth-shaded oceans.
"""
from __future__ import annotations

import numpy as np
from scipy.ndimage import gaussian_filter

# Koppen-Geiger class palette, index 0 = unknown. 31 natural-tone colors.
KOPPEN_CLASSES = [
    "Unknown", "Af", "Am", "Aw", "BWh", "BWk", "BSh", "BSk", "Csa", "Csb",
    "Csc", "Cwa", "Cwb", "Cwc", "Cfa", "Cfb", "Cfc", "Dsa", "Dsb", "Dsc",
    "Dsd", "Dwa", "Dwb", "Dwc", "Dwd", "Dfa", "Dfb", "Dfc", "Dfd", "ET", "EF",
]


def biome_palette() -> np.ndarray:
    """(31, 3) float RGB palette for Koppen classes (earth tones)."""
    hues = np.array([
        [0, 0, 0],
        [18, 88, 26], [40, 122, 42], [186, 210, 94],           # A
        [228, 193, 124], [218, 201, 165], [211, 169, 92], [204, 183, 138],  # B
        [177, 157, 80], [163, 149, 86], [149, 141, 106],       # Cs
        [133, 179, 98], [113, 165, 98], [97, 149, 98],         # Cw
        [125, 187, 86], [97, 169, 86], [77, 141, 78],          # Cf
        [121, 141, 161], [109, 131, 151], [97, 121, 141], [89, 113, 133],  # Ds
        [137, 153, 177], [113, 137, 169], [101, 121, 161], [85, 105, 141],  # Dw
        [121, 171, 121], [97, 151, 121], [73, 121, 111], [65, 97, 109],    # Df
        [174, 181, 181], [231, 239, 245],                      # E
    ], dtype=np.float32)
    return hues / 255.0


def _hillshade(elev: np.ndarray, resolution: float, azimuth_deg: float = 315.0,
               altitude_deg: float = 45.0) -> np.ndarray:
    dy, dx = np.gradient(elev)
    scale = 15 * resolution / 90
    dy, dx = dy / scale, dx / scale
    slope = np.pi / 2 - np.arctan(np.hypot(dx, dy))
    aspect = np.arctan2(dy, -dx)
    az = np.deg2rad(azimuth_deg)
    alt = np.deg2rad(altitude_deg)
    hs = np.sin(alt) * np.sin(slope) + np.cos(alt) * np.cos(slope) * np.cos(az - aspect)
    return np.clip(hs, 0.0, 1.0).astype(np.float32)


def _terrain_colormap(norm: np.ndarray) -> np.ndarray:
    """Land colormap: green lowlands -> brown -> grey -> white peaks."""
    stops = np.array([
        [0.16, 0.52, 0.26],
        [0.53, 0.72, 0.34],
        [0.87, 0.83, 0.52],
        [0.62, 0.46, 0.32],
        [0.58, 0.55, 0.54],
        [0.92, 0.92, 0.94],
    ], dtype=np.float32)
    pos = np.array([0.0, 0.2, 0.42, 0.65, 0.85, 1.0], dtype=np.float32)
    n = np.clip(norm, 0.0, 1.0)
    rgb = np.empty((*n.shape, 3), dtype=np.float32)
    for c in range(3):
        rgb[..., c] = np.interp(n, pos, stops[:, c])
    return rgb


def get_relief_map(
    elevation,
    climate=None,
    biome=None,
    flow=None,
    *,
    azimuths=(315.0, 45.0, 135.0, 225.0),
    flow_threshold: float = 7,
    sigma_large: float = 6.0,
    sigma_small: float = 1.2,
    resolution: float = 90,
    rgb: np.ndarray | None = None,
    relief: float = 1.0,
    vmin: float | None = None,
    vmax: float | None = None,
) -> np.ndarray:
    """Render (H, W, 3) float RGB shaded relief (same signature surface as the
    reference renderer)."""
    elev = np.asarray(elevation, dtype=np.float32)
    assert elev.ndim == 2
    if np.isnan(elev).any():
        med = float(np.nanmedian(elev))
        elev_f = np.nan_to_num(elev, nan=med if np.isfinite(med) else 0.0)
    else:
        elev_f = elev

    az = float(azimuths[0]) if isinstance(azimuths, (tuple, list)) else float(azimuths)
    hs_large = _hillshade(gaussian_filter(elev_f, sigma_large), resolution, az)
    hs_small = _hillshade(gaussian_filter(elev_f, sigma_small), resolution, az)
    hillshade = np.clip(0.75 * hs_large + 0.25 * hs_small, 0, 1) ** 0.85

    if rgb is None:
        land = np.maximum(0, elev_f)
        if vmin is None or vmax is None:
            _vmin, _vmax = float(land.min()), float(land.max())
            if _vmax == _vmin:
                _vmin, _vmax = 0.0, 1.0
        else:
            _vmin, _vmax = max(0.0, float(vmin)), float(vmax)
        norm = (land - _vmin) / (_vmax - _vmin + 1e-8)
        rgb = _terrain_colormap(np.clip(norm, 0, 1) ** 0.7)

    base_rgb = rgb
    if biome is not None:
        b_idx = np.asarray(biome).astype(np.int32)
        if b_idx.shape == elev.shape:
            lut = biome_palette()
            b_idx = np.clip(b_idx, 0, lut.shape[0] - 1)
            mask = (b_idx > 0)[..., None]
            base_rgb = np.where(mask, lut[b_idx], base_rgb)

    intensity = 0.35 + 0.65 * hillshade
    shaded = np.clip(base_rgb * (relief * intensity + (1 - relief))[..., None], 0, 1)

    if flow is not None:
        fl = np.asarray(flow, dtype=np.float32)
        river = fl > float(flow_threshold)
        if river.any():
            rc = np.array([0.10, 0.45, 0.85], dtype=np.float32)
            shaded[river] = 0.25 * shaded[river] + 0.75 * rc[None, :]

    ocean = elev_f < 0
    if ocean.any():
        t = np.zeros_like(elev_f)
        t[ocean] = np.clip(-elev_f[ocean] / 10_000.0, 0, 1)
        t = (t ** 0.7)[..., None]
        coast = np.array([0.68, 0.88, 1.00], dtype=np.float32)
        deep = np.array([0.00, 0.10, 0.45], dtype=np.float32)
        shaded = np.where(ocean[..., None], (1 - t) * coast + t * deep, shaded)

    shaded[np.isnan(elev)] = np.nan
    return shaded
