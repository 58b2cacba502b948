"""Synthetic conditioning map: Perlin FBm fields quantile-matched to global
terrain/climate distributions, plus climate-consistency finalization.

Counterpart of ``terrain_diffusion_tpu.pipeline.synthetic_map``'s factory:
five FBm fields (elevation / temperature / temperature seasonality /
precipitation / precipitation CV) with per-channel frequency multipliers,
quantile-matched to data distributions; ``finalize`` applies the
lapse-rate temperature adjustment, the sub-20C stretch, the seasonality
re-baselining and the precipitation-CV damping.  Host-side NumPy.
"""
from __future__ import annotations

import functools
import random

import numpy as np

from terrain_diffusion_tpu_torch.ops.perlin import perlin_fbm
from terrain_diffusion_tpu_torch.pipeline.quantiles import build_quantiles, transform_perlin

_MAP_CONFIGS = [  # (freq_base, octaves, lacunarity, gain) per channel
    (0.05, 4, 2.0, 0.5),
    (0.05, 2, 2.0, 0.5),
    (0.05, 4, 2.0, 0.5),
    (0.05, 4, 2.0, 0.5),
    (0.05, 4, 2.0, 0.5),
]


@functools.lru_cache(maxsize=32)
def _noise_quantiles(freq: float, octaves: int, lacunarity: float, gain: float) -> np.ndarray:
    """FBm value-distribution quantiles on a 1024x1024 lattice (fixed seed 1;
    the distribution does not depend on the seed)."""
    xs = np.arange(0, 32 * 1024, 32, dtype=np.float32)
    xx, yy = np.meshgrid(xs, xs)
    vals = perlin_fbm(1, freq, octaves, lacunarity, gain, xx.ravel(), yy.ravel())
    q = build_quantiles(vals, n_quantiles=64, eps=1e-4)
    q.setflags(write=False)
    return q


def make_synthetic_map_factory(frequency_mult=(1.0, 1.0, 1.0, 1.0, 1.0),
                               seed: int | None = None,
                               drop_water_pct: float = 0.0,
                               stats: dict | None = None):
    """Returns ``sample(i1, j1, i2, j2) -> (5, i2-i1, j2-j1) float32`` with
    ``.sample_raw`` and ``.finalize`` attributes.  Stats default to the
    built-in tables (``data.default_stats``)."""
    base_seed = seed if seed is not None else random.randint(0, 2 ** 30)
    actual_seeds = [(base_seed + i + 1) & 0x7FFFFFFF for i in range(5)]
    if stats is None:
        from terrain_diffusion_tpu_torch.data.default_stats import default_stats

        stats = default_stats(drop_water_pct)
    a_temp_std = float(stats["a_temp_std"])
    b_temp_std = float(stats["b_temp_std"])
    temp_std_p1 = float(stats["temp_std_p1"])
    temp_std_p99 = float(stats["temp_std_p99"])

    chans = []
    for i, (freq_base, octaves, lac, gain) in enumerate(_MAP_CONFIGS):
        freq = freq_base * frequency_mult[i]
        # noise tables always come from this package's Perlin: a pure
        # function of (implementation, freq, octaves, lacunarity, gain)
        nq = _noise_quantiles(freq, octaves, lac, gain)
        bq = np.asarray(stats[f"base_image_quantiles_{i}"], dtype=np.float64)
        chans.append((actual_seeds[i], freq, octaves, lac, gain, nq, bq))

    def _sample_channel(ch, i1, j1, i2, j2):
        # value at world cell (i, j) = FBm(x=j, y=i)
        s, freq, octaves, lac, gain, nq, bq = ch
        ys, xs = np.meshgrid(np.arange(i1, i2, dtype=np.float32),
                             np.arange(j1, j2, dtype=np.float32), indexing="ij")
        vals = perlin_fbm(s, freq, octaves, lac, gain, xs.ravel(), ys.ravel())
        vals = transform_perlin(vals, nq, bq)
        return vals.reshape(i2 - i1, j2 - j1).astype(np.float32)

    def sample_raw(i1, j1, i2, j2) -> np.ndarray:
        return np.stack([_sample_channel(c, i1, j1, i2, j2) for c in chans], axis=0)

    def finalize(raw_map) -> np.ndarray:
        elev, temp, temp_std, precip, precip_std = (
            np.asarray(raw_map[k], dtype=np.float32) for k in range(5))
        lapse_rate = np.clip(-6.5 + 0.0015 * precip, -9.8, -4.0) / 1000
        temp = temp + lapse_rate * np.maximum(0, elev)
        temp = np.clip(temp, -10, 40)
        temp = np.where(temp > 20, temp, (temp - 20) * 1.25 + 20)

        t = (temp_std - temp_std_p1) / (temp_std_p99 - temp_std_p1)
        baseline = np.maximum(temp_std_p1, -(a_temp_std * temp + b_temp_std))
        temp_std = t * (temp_std_p99 - baseline) + baseline
        temp_std = temp_std + (a_temp_std * temp + b_temp_std)
        temp_std = np.maximum(temp_std, 20)

        precip_std = precip_std * np.maximum(0, (185 - 0.04111 * precip) / 185)
        return np.stack([elev, temp, temp_std, precip, precip_std], axis=0)

    def sample_full(i1, j1, i2, j2) -> np.ndarray:
        m = finalize(sample_raw(i1, j1, i2, j2))
        m[0] = np.sign(m[0]) * np.sqrt(np.abs(m[0]))
        return m.astype(np.float32)

    sample_full.sample_raw = sample_raw
    sample_full.finalize = finalize
    return sample_full
