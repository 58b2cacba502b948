"""Default synthetic-map statistics (quantile tables + climate fit scalars).

Counterpart of ``terrain_diffusion_tpu.data.default_stats``: documented
approximations built from published global summary statistics, standing in
for the ETOPO / WorldClim rasters the reference derives its tables from -
Earth's hypsometric curve for elevation (with the ``drop_water_pct`` ocean
down-weighting applied analytically) and parametric marginals for sea-level
temperature, temperature seasonality, precipitation and precipitation CV.
Noise quantile tables are computed from the port's own Perlin, so only the
data-side tables are approximate.
"""
from __future__ import annotations

import numpy as np

from terrain_diffusion_tpu_torch.pipeline.quantiles import build_quantiles

# Earth's hypsometric curve: (elevation m, cumulative fraction of surface at
# or below).  Values from standard published hypsometry (ETOPO-derived).
_HYPSOMETRY = np.array([
    [-10500.0, 0.0002],
    [-7000.0, 0.01],
    [-6000.0, 0.03],
    [-5000.0, 0.14],
    [-4500.0, 0.245],
    [-4000.0, 0.35],
    [-3500.0, 0.43],
    [-3000.0, 0.49],
    [-2500.0, 0.53],
    [-2000.0, 0.565],
    [-1000.0, 0.625],
    [-200.0, 0.695],
    [0.0, 0.71],
    [100.0, 0.76],
    [200.0, 0.795],
    [500.0, 0.874],
    [1000.0, 0.931],
    [1500.0, 0.957],
    [2000.0, 0.972],
    [3000.0, 0.988],
    [4000.0, 0.9953],
    [5000.0, 0.9985],
    [6000.0, 0.9997],
    [8000.0, 1.0],
])


def _elev_quantiles(drop_water_pct: float, n: int = 64) -> np.ndarray:
    """Quantiles of elevation after randomly dropping `drop_water_pct` of
    below-sea-level samples (reference hist_mask, synthetic_map.py:113)."""
    elev = _HYPSOMETRY[:, 0]
    cdf = _HYPSOMETRY[:, 1]
    # reweight: ocean mass scaled by (1 - drop_water_pct)
    ocean_frac = np.interp(0.0, elev, cdf)
    w_ocean = 1.0 - drop_water_pct
    new_cdf = np.where(
        elev <= 0.0,
        cdf * w_ocean,
        ocean_frac * w_ocean + (cdf - ocean_frac),
    )
    new_cdf = new_cdf / new_cdf[-1]
    eps = 1e-4
    q = np.linspace(eps, 1 - eps, n)
    return np.interp(q, new_cdf, elev)


def _gaussianish_quantiles(mean, std, lo, hi, skew: float = 0.0, n: int = 64) -> np.ndarray:
    """Clipped, optionally skewed normal quantile table."""
    rng = np.random.default_rng(12345)
    s = rng.standard_normal(200_000)
    if skew:
        s = s + skew * (s**2 - 1) / 2
    vals = np.clip(mean + std * s, lo, hi)
    return build_quantiles(vals, n_quantiles=n)


# Linear fit of temperature seasonality (bio4, std*100) vs mean temp (C):
# seasonality falls from ~1450 at -10C to ~0 at 27C; tuned so finalized
# temp_std matches the coarse-channel stats the pipeline records
# (mean ~334, std ~322, `world_pipeline.py:358-360`).
A_TEMP_STD = -40.0
B_TEMP_STD = 1050.0
TEMP_STD_P1 = -500.0
TEMP_STD_P99 = 600.0


def default_stats(drop_water_pct: float = 0.5) -> dict:
    """Stats dict in the reference's in-memory format
    (keys `noise_quantiles_{i}` are filled by the synthetic-map factory)."""
    stats = {
        "a_temp_std": A_TEMP_STD,
        "b_temp_std": B_TEMP_STD,
        "temp_std_p1": TEMP_STD_P1,
        "temp_std_p99": TEMP_STD_P99,
        # channel 0: raw elevation (meters, pre-signed-sqrt)
        "base_image_quantiles_0": _elev_quantiles(drop_water_pct),
        # channel 1: sea-level-adjusted mean temperature (C)
        "base_image_quantiles_1": _gaussianish_quantiles(14.0, 12.0, -38.0, 38.0, skew=-0.4),
        # channel 2: temperature seasonality residual (bio4 - linear fit)
        "base_image_quantiles_2": _gaussianish_quantiles(0.0, 260.0, -900.0, 1100.0, skew=0.3),
        # channel 3: annual precipitation (mm)
        "base_image_quantiles_3": _gaussianish_quantiles(700.0, 650.0, 10.0, 6000.0, skew=1.6),
        # channel 4: precipitation CV (bio15)
        "base_image_quantiles_4": _gaussianish_quantiles(62.0, 32.0, 8.0, 190.0, skew=0.7),
    }
    return stats
