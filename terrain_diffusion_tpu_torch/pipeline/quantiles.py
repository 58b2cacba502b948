"""Quantile matching (counterpart of ``terrain_diffusion_tpu.pipeline.quantiles``).

Maps Perlin FBm value distributions onto empirical data distributions via
64-knot quantile tables and piecewise-linear interpolation.
"""
from __future__ import annotations

import numpy as np


def build_quantiles(values, n_quantiles: int = 32, eps: float = 1e-4) -> np.ndarray:
    """Strictly-increasing empirical quantile knots of `values`."""
    v = np.asarray(values, dtype=np.float64).ravel()
    v = v[~np.isnan(v)]
    v_q = np.quantile(v, np.linspace(eps, 1.0 - eps, n_quantiles))
    diffs = np.diff(v_q)
    min_diff = np.min(diffs[diffs > 0]) if np.any(diffs > 0) else 1e-10
    for i in range(1, len(v_q)):
        if v_q[i] <= v_q[i - 1]:
            v_q[i] = v_q[i - 1] + min_diff * 0.1
    return v_q


def transform_perlin(perlin_map, source_quantiles, target_quantiles):
    """Monotone remap: source distribution -> target distribution."""
    if len(source_quantiles) != len(target_quantiles):
        raise ValueError("source and target quantiles must have the same length")
    return np.interp(perlin_map, source_quantiles, target_quantiles,
                     left=target_quantiles[0], right=target_quantiles[-1])
