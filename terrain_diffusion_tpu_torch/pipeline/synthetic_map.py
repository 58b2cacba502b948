"""Synthetic conditioning map: Perlin FBm fields quantile-matched to global
terrain/climate distributions, plus climate-consistency finalization.

Counterpart of ``terrain_diffusion_tpu.pipeline.synthetic_map``'s factory:
five FBm fields (elevation / temperature / temperature seasonality /
precipitation / precipitation CV) with per-channel frequency multipliers,
quantile-matched to data distributions; ``finalize`` applies the
lapse-rate temperature adjustment, the sub-20C stretch, the seasonality
re-baselining and the precipitation-CV damping.  Host-side NumPy.

The data-side stats come from, in this order: an explicit ``stats`` dict,
the JSON cache that ``build-synthetic-stats`` writes
(``STATS_CACHE_PATH``, the JAX package's format), or the built-in tables
(``data.default_stats``).
"""
from __future__ import annotations

import functools
import json
import os
import random

import click
import numpy as np

from terrain_diffusion_tpu_torch.ops.perlin import perlin_fbm
from terrain_diffusion_tpu_torch.pipeline.quantiles import build_quantiles, transform_perlin

STATS_CACHE_PATH = "data/global/synthetic_map_stats.json"

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


def _listed(params: dict) -> dict:
    return {k: (list(v) if isinstance(v, (list, tuple)) else v) for k, v in params.items()}


def load_stats_cache(path: str = STATS_CACHE_PATH, expect_params=None):
    """The stats of a JSON cache, or None when there is no readable cache.

    ``expect_params`` ({"drop_water_pct", "frequency_mult"}) rejects a cache
    whose recorded build parameters differ: its quantile tables bake them
    in.  A cache without a ``params`` record is taken as it is.
    """
    if not os.path.exists(path):
        return None
    try:
        with open(path, "r", encoding="utf-8") as f:
            data = json.load(f)
        if expect_params is not None and "params" in data:
            got, want = data["params"], _listed(expect_params)
            if any(got.get(k) != want[k] for k in want):
                print(f"[synthetic_map] stats cache {path} was built with "
                      f"{got}, requested {want}: ignoring the cache")
                return None
        stats = {k: float(data[k]) for k in
                 ("a_temp_std", "b_temp_std", "temp_std_p1", "temp_std_p99")}
        for i, q in enumerate(data["data_quantile_tables"]):
            stats[f"base_image_quantiles_{i}"] = np.asarray(q, dtype=np.float64)
        for i, q in enumerate(data.get("noise_quantile_tables", [])):
            stats[f"noise_quantiles_{i}"] = np.asarray(q, dtype=np.float64)
        return stats
    except (OSError, ValueError, KeyError, TypeError):  # unreadable: as if absent
        return None


def save_stats_cache(stats: dict, path: str = STATS_CACHE_PATH, params=None):
    """Write ``stats`` (and the build ``params``) as the JSON cache."""
    if os.path.dirname(path):
        os.makedirs(os.path.dirname(path), exist_ok=True)
    payload = {
        "n_quantiles": 64,
        "noise_quantile_tables": [np.asarray(stats[f"noise_quantiles_{i}"]).tolist()
                                  for i in range(5) if f"noise_quantiles_{i}" in stats],
        "data_quantile_tables": [np.asarray(stats[f"base_image_quantiles_{i}"]).tolist()
                                 for i in range(5)],
        "a_temp_std": float(stats["a_temp_std"]),
        "b_temp_std": float(stats["b_temp_std"]),
        "temp_std_p1": float(stats["temp_std_p1"]),
        "temp_std_p99": float(stats["temp_std_p99"]),
    }
    if params is not None:
        payload["params"] = _listed(params)
    with open(path, "w", encoding="utf-8") as f:
        json.dump(payload, f)


RASTER_FILES = {  # ETOPO 10' elevation and four WorldClim 10' bio layers
    "elev": "etopo_10m.tif",
    "temp": "wc2.1_10m_bio_1.tif",
    "temp_std": "wc2.1_10m_bio_4.tif",
    "precip": "wc2.1_10m_bio_12.tif",
    "precip_cv": "wc2.1_10m_bio_15.tif",
}


def compute_map_stats(frequency_mult=(1.0, 1.0, 1.0, 1.0, 1.0),
                      drop_water_pct: float = 0.0,
                      data_dir: str = "data/global") -> dict:
    """Quantile-matching stats from the global rasters in ``data_dir``:
    polar sixths cropped, nodata masked, temperature seasonality re-baselined
    by a linear fit on temperature, lapse-rate sea-level temperature,
    0.1 / 99.9 seasonality percentiles, 64-knot quantile tables with a
    drop-water mask on elevation; the noise tables from this package's
    Perlin.  Host NumPy, float64."""
    from terrain_diffusion_tpu_torch.common.geotiff import read_geotiff

    def read(name):
        path = os.path.join(data_dir, RASTER_FILES[name])
        if not os.path.exists(path):
            raise FileNotFoundError(
                f"{path} missing - synthetic-map stats need the ETOPO/"
                "WorldClim rasters (see RASTER_FILES)")
        arr, _t, nodata = read_geotiff(path)
        img = np.asarray(arr, dtype=np.float64)
        h = img.shape[0]
        img = img[h // 6: h - h // 6, :]  # crop polar sixths
        img[img < -30000] = np.nan
        if nodata is not None:
            img[img == nodata] = np.nan
        return img

    elev, temp, temp_std, precip, precip_cv = (
        read(k) for k in ("elev", "temp", "temp_std", "precip", "precip_cv"))

    # joint mask: polyfit and percentile are not NaN-aware
    valid = ~np.isnan(temp) & ~np.isnan(temp_std)
    a_temp_std, b_temp_std = np.polyfit(temp[valid], temp_std[valid], 1)
    temp_std = temp_std - (a_temp_std * temp + b_temp_std)

    lapse = np.clip(-6.5 + 0.0015 * precip, -9.8, -4.0) / 1000
    temp = temp - lapse * np.maximum(0, elev)

    stats = {
        "a_temp_std": float(a_temp_std),
        "b_temp_std": float(b_temp_std),
        "temp_std_p1": float(np.percentile(temp_std[valid], 0.1)),
        "temp_std_p99": float(np.percentile(temp_std[valid], 99.9)),
    }
    rng = np.random.default_rng(0)
    hist_mask = np.logical_or(rng.random(elev.shape) > drop_water_pct, elev >= 0)
    images = [(elev, hist_mask), (temp, None), (temp_std, None),
              (precip, None), (precip_cv, None)]
    for i, ((freq_base, octaves, lac, gain), (img, mask)) in enumerate(
            zip(_MAP_CONFIGS, images)):
        stats[f"noise_quantiles_{i}"] = np.array(_noise_quantiles(
            freq_base * frequency_mult[i], octaves, lac, gain))
        vals = img[mask] if mask is not None else img
        stats[f"base_image_quantiles_{i}"] = build_quantiles(vals, n_quantiles=64, eps=1e-4)
    return stats


def make_synthetic_map_factory(frequency_mult=(1.0, 1.0, 1.0, 1.0, 1.0),
                               seed: int | None = None,
                               drop_water_pct: float = 0.0,
                               stats: dict | None = None,
                               stats_path: str = STATS_CACHE_PATH):
    """Returns ``sample(i1, j1, i2, j2) -> (5, i2-i1, j2-j1) float32`` with
    ``.sample_raw`` and ``.finalize`` attributes.  Without ``stats``, the
    cache at ``stats_path`` when its params match, else the built-in
    tables."""
    base_seed = seed if seed is not None else random.randint(0, 2 ** 30)
    actual_seeds = [(base_seed + i + 1) & 0x7FFFFFFF for i in range(5)]
    if stats is None:
        stats = load_stats_cache(stats_path, expect_params={
            "drop_water_pct": drop_water_pct, "frequency_mult": list(frequency_mult)})
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


@click.command("build-synthetic-stats")
@click.option("--data-dir", default="data/global",
              help="directory with the ETOPO/WorldClim rasters")
@click.option("--out", default=STATS_CACHE_PATH)
@click.option("--frequency-mult", default="1.5,3,3,3,3",
              help="per-channel frequency multipliers")
@click.option("--drop-water-pct", type=float, default=0.5)
def build_stats_main(data_dir, out, frequency_mult, drop_water_pct):
    """Recompute the synthetic-map quantile stats from global rasters and
    write the JSON cache that worlds with these parameters then read."""
    fm = [float(x) for x in frequency_mult.split(",")]
    stats = compute_map_stats(fm, drop_water_pct, data_dir)
    save_stats_cache(stats, out, params={"drop_water_pct": drop_water_pct,
                                         "frequency_mult": fm})
    print(f"wrote {out} (a={stats['a_temp_std']:.4f} "
          f"b={stats['b_temp_std']:.2f} "
          f"p1={stats['temp_std_p1']:.2f} p99={stats['temp_std_p99']:.2f})")
    return stats
