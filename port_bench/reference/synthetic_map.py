"""The synthetic conditioning map: frozen copy of the port's host paths
(``ops/perlin.py``'s NumPy FBm, ``pipeline/quantiles.py``,
``data/default_stats.py`` and ``pipeline/synthetic_map.py``'s factory).
The world reads no stats cache in the benchmark's checkout, so the
built-in tables are the stats here."""
from __future__ import annotations

import functools

import numpy as np

_PRIME_X = np.int32(501125321)
_PRIME_Y = np.int32(1136930381)
_HASH_MULT = np.uint32(0x27D4EB2D)


def _gradient_table() -> np.ndarray:
    """128 unit gradient pairs: 24 directions at (7.5 + 15k) deg, cycled."""
    a = np.deg2rad(7.5 + 15.0 * (np.arange(128) % 24))
    g = np.empty(256, dtype=np.float32)
    g[0::2] = np.sin(a)
    g[1::2] = np.cos(a)
    return g


_GRAD = _gradient_table()


def _grad_coord(seed, xp, yp, xd, yd):
    h = (seed ^ xp ^ yp).astype(np.int32)
    h = (h.view(np.uint32) * _HASH_MULT).view(np.int32)
    h = h ^ (h >> np.int32(15))
    h = h & np.int32(127 << 1)
    return xd * _GRAD[h] + yd * _GRAD[h | 1]


def _quintic(t):
    return t * t * t * (t * (t * 6 - 15) + 10)


def _perlin_single(seed: np.int32, x: np.ndarray, y: np.ndarray) -> np.ndarray:
    x0 = np.floor(x).astype(np.int64)
    y0 = np.floor(y).astype(np.int64)
    xd0 = (x - x0).astype(np.float32)
    yd0 = (y - y0).astype(np.float32)
    xd1, yd1 = xd0 - 1, yd0 - 1
    xs, ys = _quintic(xd0), _quintic(yd0)
    with np.errstate(over="ignore"):
        x0p = (x0.astype(np.int32).view(np.uint32) * _PRIME_X.view(np.uint32)).view(np.int32)
        y0p = (y0.astype(np.int32).view(np.uint32) * _PRIME_Y.view(np.uint32)).view(np.int32)
        x1p = (x0p.view(np.uint32) + _PRIME_X.view(np.uint32)).view(np.int32)
        y1p = (y0p.view(np.uint32) + _PRIME_Y.view(np.uint32)).view(np.int32)
    g00 = _grad_coord(seed, x0p, y0p, xd0, yd0)
    g10 = _grad_coord(seed, x1p, y0p, xd1, yd0)
    g01 = _grad_coord(seed, x0p, y1p, xd0, yd1)
    g11 = _grad_coord(seed, x1p, y1p, xd1, yd1)
    xf0 = g00 + xs * (g10 - g00)
    xf1 = g01 + xs * (g11 - g01)
    return (xf0 + ys * (xf1 - xf0)) * np.float32(1.4247691104677813)


def fractal_bounding(octaves: int, gain: float) -> float:
    """FBm octave normalizer: 1 / (1 + g + ... + g^(octaves-1))."""
    g = abs(gain)
    amp, amp_fractal = g, 1.0
    for _ in range(1, octaves):
        amp_fractal += amp
        amp *= g
    return 1.0 / amp_fractal


def perlin_fbm_np(seed: int, frequency: float, octaves: int, lacunarity: float,
                  gain: float, xs: np.ndarray, ys: np.ndarray) -> np.ndarray:
    """Vectorized NumPy FBm at coordinates (pre-frequency units)."""
    x = np.asarray(xs, dtype=np.float32) * frequency
    y = np.asarray(ys, dtype=np.float32) * frequency
    total = np.zeros_like(x, dtype=np.float32)
    amp = fractal_bounding(octaves, gain)
    s = int(seed)
    for _ in range(octaves):
        s32 = ((s + 2**31) % 2**32) - 2**31  # wrap to int32 range
        total += _perlin_single(np.int32(s32), x, y) * amp
        s += 1
        x = x * lacunarity
        y = y * lacunarity
        amp *= gain
    return total


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
    vals = perlin_fbm_np(1, freq, octaves, lacunarity, gain, xx.ravel(), yy.ravel())
    q = build_quantiles(vals, n_quantiles=64, eps=1e-4)
    q.setflags(write=False)
    return q


def make_synthetic_map_factory(frequency_mult, seed: int, drop_water_pct: float):
    """``sample(i1, j1, i2, j2) -> (5, i2-i1, j2-j1) float32``: the finalized
    map with the signed square root of elevation, over the built-in stats."""
    actual_seeds = [(seed + i + 1) & 0x7FFFFFFF for i in range(5)]
    stats = default_stats(drop_water_pct)
    a_temp_std = float(stats["a_temp_std"])
    b_temp_std = float(stats["b_temp_std"])
    temp_std_p1 = float(stats["temp_std_p1"])
    temp_std_p99 = float(stats["temp_std_p99"])

    chans = []
    for i, (freq_base, octaves, lac, gain) in enumerate(_MAP_CONFIGS):
        freq = freq_base * frequency_mult[i]
        nq = _noise_quantiles(freq, octaves, lac, gain)
        bq = np.asarray(stats[f"base_image_quantiles_{i}"], dtype=np.float64)
        chans.append((actual_seeds[i], freq, octaves, lac, gain, nq, bq))

    def _sample_channel(ch, i1, j1, i2, j2):
        # value at world cell (i, j) = FBm(x=j, y=i)
        s, freq, octaves, lac, gain, nq, bq = ch
        ys, xs = np.meshgrid(np.arange(i1, i2, dtype=np.float32),
                             np.arange(j1, j2, dtype=np.float32), indexing="ij")
        vals = perlin_fbm_np(s & 0x7FFFFFFF, freq, octaves, lac, gain, xs.ravel(), ys.ravel())
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

    return sample_full
