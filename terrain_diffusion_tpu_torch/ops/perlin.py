"""Perlin FBm noise (FastNoiseLite-compatible algorithm) on the host.

Counterpart of the host paths of ``terrain_diffusion_tpu.ops.perlin``:
hash-based gradient Perlin, quintic interpolation, FBm octave stacking with
the exact fractal bounding ``1 / (1 + g + ... + g^(octaves-1))``.
``perlin_fbm`` takes the native C++ library
(``terrain_diffusion_tpu_torch.native``) when it is built, else the
vectorized NumPy path ``perlin_fbm_np``; both give the same floats.
"""
from __future__ import annotations

import numpy as np

from terrain_diffusion_tpu_torch.native import get_native

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


def perlin_fbm(seed: int, frequency: float, octaves: int, lacunarity: float,
               gain: float, xs: np.ndarray, ys: np.ndarray) -> np.ndarray:
    """FBm Perlin at coordinates (pre-frequency units); the seed keeps its
    low 31 bits.  Native C++ when loaded, else NumPy."""
    seed = int(seed) & 0x7FFFFFFF
    nat = get_native()
    if nat is not None:
        out = nat.perlin_fbm_coords(seed, frequency, octaves, lacunarity, gain,
                                    np.ravel(xs), np.ravel(ys))
        return out.reshape(np.shape(xs))
    return perlin_fbm_np(seed, frequency, octaves, lacunarity, gain, xs, ys)
