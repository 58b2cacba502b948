"""Deterministic, O(1)-random-access tiled Gaussian noise fields.

Counterpart of ``terrain_diffusion_tpu.ops.noise_field``.  Two fields back
every stochastic input of the pipeline; in both the value at (c, y, x)
depends only on the seed and the tile it falls in, so any crop is computable
in isolation and overlapping crops agree bit for bit (negative coordinates
included):

1. ``gaussian_noise_patch`` - the *portable* host field: per-tile
   PCG64+Marsaglia streams seeded by ``tile_seed(base, ty, tx)``.
2. ``threefry_noise_patch`` / ``threefry_noise_batch`` - the *threefry*
   field, the JAX package's default: JAX's counter-based threefry2x32,
   keyed per tile as ``fold_in(fold_in(fold_in(key(lo), hi), ty), tx)`` and
   drawn as ``jax.random.normal`` draws it (jax 0.9.0,
   ``jax_threefry_partitionable=True``).  It runs as integer tensor ops on
   the tensor's device: uint32 words live in int64 lanes masked to 32 bits.
   The bits equal JAX's; the uniform -> normal transform is XLA's f32
   ``erf_inv`` polynomial written with correctly rounded ops only (+, -, *,
   /, a square root taken in float64, bit casts), so the CPU and the card
   give the same floats, and JAX's values within a few float32 ulps (its
   log1p differs).

``key_from_seed`` / ``split`` / ``normal`` are ``jax.random.key`` /
``split`` / ``normal`` on explicit keys, the generator of the evaluation
samplers: the same seed gives JAX's draws.
"""
from __future__ import annotations

import numpy as np
import torch

from terrain_diffusion_tpu_torch.ops.rng_portable import fill_standard_normal, tile_seed

_M32 = 0xFFFFFFFF


# ---------------------------------------------------------------------------
# Portable host field (PCG64 + Marsaglia per tile)
# ---------------------------------------------------------------------------

def gaussian_noise_patch(base_seed: int, y0: int, x0: int, h: int, w: int,
                         channels: int = 1, tile_h: int = 256, tile_w: int = 256,
                         dtype=np.float32) -> np.ndarray:
    """(C, H, W) crop of an infinite tile-seeded Gaussian field."""
    out = np.empty((channels, h, w), dtype=dtype)
    tile = np.empty((channels, tile_h, tile_w), dtype=dtype)
    for ty in range(y0 // tile_h, (y0 + h - 1) // tile_h + 1):
        tile_y0 = ty * tile_h
        for tx in range(x0 // tile_w, (x0 + w - 1) // tile_w + 1):
            tile_x0 = tx * tile_w
            oy0, oy1 = max(y0, tile_y0), min(y0 + h, tile_y0 + tile_h)
            ox0, ox1 = max(x0, tile_x0), min(x0 + w, tile_x0 + tile_w)
            fill_standard_normal(tile_seed(base_seed, ty, tx), tile)
            out[:, oy0 - y0:oy1 - y0, ox0 - x0:ox1 - x0] = tile[
                :, oy0 - tile_y0:oy1 - tile_y0, ox0 - tile_x0:ox1 - tile_x0]
    return out


# ---------------------------------------------------------------------------
# Threefry field
# ---------------------------------------------------------------------------

def split_seed(seed: int) -> tuple[int, int]:
    """Split a 64-bit python int seed into (lo32, hi32)."""
    seed = int(seed) & 0xFFFFFFFFFFFFFFFF
    return seed & _M32, seed >> 32


def seed_to_pair(seed: int) -> np.ndarray:
    """(2,) uint32 [lo, hi] representation of a 64-bit seed."""
    return np.asarray(split_seed(seed), dtype=np.uint32)


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _M32


def threefry2x32(k1, k2, x1, x2):
    """Threefry-2x32, 20 rounds (JAX's ``threefry2x32_p``), on int64 tensors
    holding uint32 values; arguments broadcast.  Returns (y1, y2)."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x1 = (x1 + ks[0]) & _M32
    x2 = (x2 + ks[1]) & _M32
    rotations = ((13, 15, 26, 6), (17, 29, 16, 24))
    for i in range(5):
        for r in rotations[i % 2]:
            x1 = (x1 + x2) & _M32
            x2 = _rotl(x2, r) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & _M32
        x2 = (x2 + ks[(i + 2) % 3] + (i + 1)) & _M32
    return x1, x2


def _as_words(v, device) -> torch.Tensor:
    """int64 tensor of uint32 words from ints (negative ints wrap, as
    JAX's int32 -> uint32 cast does)."""
    return torch.as_tensor(np.asarray(v, np.int64) & _M32, device=device)


def fold_in(key, data):
    """``jax.random.fold_in``: key (k1, k2), data uint32 words -> new key."""
    zero = torch.zeros_like(data)
    return threefry2x32(key[0], key[1], zero, data)


def seed_key(seed, device="cpu"):
    """Key of a seed (python int or (2,) uint32 [lo, hi] pair):
    ``fold_in(jax.random.key(uint32(lo)), hi)`` as (k1, k2) int64 scalars."""
    lo, hi = (split_seed(seed) if isinstance(seed, (int, np.integer))
              else (int(seed[0]), int(seed[1])))
    key = (_as_words(0, device), _as_words(lo, device))  # key(uint32) = [0, lo]
    return fold_in(key, _as_words(hi, device))


def _tile_key(seed, ty, tx, device="cpu"):
    """Per-tile key of (seed, ty, tx); ty/tx are ints or int arrays (any
    shape, broadcast).  Returns (k1, k2) int64 tensors of uint32 words."""
    key = seed_key(seed, device)
    key = fold_in(key, _as_words(ty, device))
    return fold_in(key, _as_words(tx, device))


def random_bits(key, counters: torch.Tensor) -> torch.Tensor:
    """32-bit ``jax.random.bits`` under jax_threefry_partitionable: the
    element with flat index i of the drawn shape gets
    ``xor(*threefry2x32(key, (i >> 32, i & 0xFFFFFFFF)))``; counters holds
    those flat indices (all below 2**32)."""
    y1, y2 = threefry2x32(key[0], key[1], torch.zeros_like(counters), counters)
    return y1 ^ y2


_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
               0.00021858087, -0.00125372503, -0.00417768164, 0.246640727,
               1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
               0.00573950773, -0.0076224613, 0.00943887047, 1.00167406,
               2.83297682)
# Cephes logf: log(1 + f) = f - f^2/2 + f^3 P(f), f in [sqrt(.5) - 1, sqrt(2) - 1)
_LOGF_P = (7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1, -1.2420140846e-1,
           1.4249322787e-1, -1.6668057665e-1, 2.0000714765e-1, -2.4999993993e-1,
           3.3333331174e-1)


def _log_f32(u: torch.Tensor) -> torch.Tensor:
    """Natural log of positive normal float32 values, Cephes' logf, from
    exactly rounded ops only (same bits on every device)."""
    bits = u.view(torch.int32)
    e = ((bits >> 23) & 0xFF) - 126                    # u = m * 2**e, m in [0.5, 1)
    m = ((bits & 0x007FFFFF) | 0x3F000000).view(torch.float32)
    small = m < 0.70710677
    e = torch.where(small, e - 1, e).to(torch.float32)
    f = torch.where(small, m + m, m) - 1.0
    z = f * f
    p = torch.full_like(f, _LOGF_P[0])
    for c in _LOGF_P[1:]:
        p = p * f + c
    y = f * z * p
    y = y + e * -2.12194440e-4
    y = y - z * 0.5
    return (f + y) + e * 0.693359375


def _log1p_f32(t: torch.Tensor) -> torch.Tensor:
    """log(1 + t) for t in (-1, 0]: log(u) of u = 1 + t, corrected by the
    rounding error of u (exact: u - 1 is exact by Sterbenz)."""
    u = 1.0 + t
    corr = ((u - 1.0) - t) / u
    return torch.where(u == 1.0, t, _log_f32(u) - corr)


def erf_inv_f32(x: torch.Tensor) -> torch.Tensor:
    """XLA's float32 ``erf_inv`` (Giles' polynomial), with edge cases."""
    w = -_log1p_f32(-(x * x))
    lt = w < 5.0
    # float32 torch.sqrt is not correctly rounded on every device (the card
    # and the CPU disagree in the last bit); the float64 root rounded to
    # float32 is the correctly rounded float32 root everywhere
    w = torch.where(lt, w - 2.5, torch.sqrt(w.double()).float() - 3.0)
    p = torch.where(lt, _ERFINV_LT5[0], _ERFINV_GE5[0])
    for a, b in zip(_ERFINV_LT5[1:], _ERFINV_GE5[1:]):
        p = torch.where(lt, a, b) + p * w
    return torch.where(x.abs() == 1.0, x * float("inf"), p * x)


_UNIFORM_LO = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))  # -0.99999994
_UNIFORM_SPAN = float(np.float32(1.0) - np.float32(_UNIFORM_LO))      # 2.0 in float32


def normal_from_bits(bits: torch.Tensor) -> torch.Tensor:
    """``jax.random.normal``'s float32 transform of 32-bit random words:
    uniform on [nextafter(-1, 0), 1) from the 23 high bits, then
    sqrt(2) * erf_inv."""
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    u = torch.clamp(f * _UNIFORM_SPAN + _UNIFORM_LO, min=_UNIFORM_LO)
    return erf_inv_f32(u) * float(np.float32(np.sqrt(2.0)))


def threefry_tile(seed, ty: int, tx: int, channels: int, tile_h: int, tile_w: int,
                  device="cpu") -> torch.Tensor:
    """One (C, tile_h, tile_w) tile of the threefry field:
    ``jax.random.normal(_tile_key(seed, ty, tx), (C, tile_h, tile_w))``."""
    ctr = torch.arange(channels * tile_h * tile_w, device=device, dtype=torch.int64)
    return normal_from_bits(random_bits(_tile_key(seed, ty, tx, device), ctr)).reshape(
        channels, tile_h, tile_w)


def threefry_noise_batch(seed, y0s, x0s, h: int, w: int, channels: int = 1,
                         tile_h: int = 256, tile_w: int = 256,
                         device="cpu") -> torch.Tensor:
    """(B, C, h, w) crops of the threefry field at corners (y0s[b], x0s[b]),
    generated together on ``device``.  Each pixel draws only its own value:
    its tile's key (computed once per tile) and its flat index in the tile."""
    y0s = np.asarray(y0s, np.int64).reshape(-1)
    x0s = np.asarray(x0s, np.int64).reshape(-1)
    ny = (h - 2) // tile_h + 2  # tiles a crop can span, at any alignment
    nx = (w - 2) // tile_w + 2
    ty0, tx0 = y0s // tile_h, x0s // tile_w
    k1, k2 = _tile_key(seed, (ty0[:, None] + np.arange(ny))[:, :, None],
                       (tx0[:, None] + np.arange(nx))[:, None, :], device)  # (B, ny, nx)
    dev = k1.device
    ys = torch.as_tensor(y0s[:, None] + np.arange(h), device=dev)  # (B, h)
    xs = torch.as_tensor(x0s[:, None] + np.arange(w), device=dev)  # (B, w)
    ty0_t = torch.as_tensor(ty0, device=dev)[:, None]
    tx0_t = torch.as_tensor(tx0, device=dev)[:, None]
    iy = torch.div(ys, tile_h, rounding_mode="floor") - ty0_t      # (B, h) tile row
    ix = torch.div(xs, tile_w, rounding_mode="floor") - tx0_t
    ry, rx = ys - (iy + ty0_t) * tile_h, xs - (ix + tx0_t) * tile_w
    b = torch.arange(len(y0s), device=dev)[:, None, None]
    tile_idx = (b * ny + iy[:, :, None]) * nx + ix[:, None, :]     # (B, h, w)
    key = (k1.reshape(-1)[tile_idx][:, None], k2.reshape(-1)[tile_idx][:, None])
    ctr = (torch.arange(channels, device=dev)[None, :, None, None] * (tile_h * tile_w)
           + (ry * tile_w)[:, None, :, None] + rx[:, None, None, :])  # (B, C, h, w)
    return normal_from_bits(random_bits(key, ctr))


def threefry_noise_patch(seed, y0: int, x0: int, *, h: int, w: int, channels: int = 1,
                         tile_h: int = 256, tile_w: int = 256,
                         device="cpu") -> torch.Tensor:
    """(C, h, w) crop of the threefry tile field at corner (y0, x0)."""
    return threefry_noise_batch(seed, [y0], [x0], h, w, channels, tile_h, tile_w,
                                device)[0]


# ---------------------------------------------------------------------------
# Explicit keys: jax.random.key / split / normal
# ---------------------------------------------------------------------------

def key_from_seed(seed: int) -> tuple[int, int]:
    """``jax.random.key(seed)`` for an int32 seed: the key words
    (0, seed mod 2**32).  A key is a pair of python ints (uint32 words)."""
    seed = int(seed)
    if not -2 ** 31 <= seed < 2 ** 31:
        raise OverflowError(f"seed {seed} is outside int32, as JAX's key() takes it")
    return 0, seed & _M32


def split(key, n: int = 2) -> list:
    """``jax.random.split(key, n)`` under jax_threefry_partitionable: key i
    is ``threefry2x32(key, (0, i))``, bit for bit."""
    k1, k2 = _as_words(key[0], "cpu"), _as_words(key[1], "cpu")
    y1, y2 = threefry2x32(k1, k2, torch.zeros(n, dtype=torch.int64),
                          torch.arange(n, dtype=torch.int64))
    return [(int(a), int(b)) for a, b in zip(y1.tolist(), y2.tolist())]


def normal(key, shape, device="cpu") -> torch.Tensor:
    """``jax.random.normal(key, shape)`` in float32 on ``device``: the bits
    equal JAX's, the values agree within 5e-7 (``normal_from_bits``)."""
    shape = tuple(int(d) for d in shape)
    ctr = torch.arange(int(np.prod(shape)), device=device, dtype=torch.int64)
    k = (_as_words(key[0], device), _as_words(key[1], device))
    return normal_from_bits(random_bits(k, ctr)).reshape(shape)


class NoiseProvider:
    """Pluggable noise backend: mode='threefry' (default) or 'portable'.
    ``patch`` returns a host (C, h, w) float32 array in both modes."""

    def __init__(self, mode: str = "threefry"):
        if mode not in ("threefry", "portable"):
            raise ValueError(f"unknown noise mode {mode!r}")
        self.mode = mode

    def patch(self, base_seed, y0, x0, h, w, channels=1, tile_h=256, tile_w=256):
        if self.mode == "portable":
            return gaussian_noise_patch(base_seed, y0, x0, h, w, channels, tile_h, tile_w)
        return threefry_noise_patch(int(base_seed) & 0xFFFFFFFFFFFFFFFF, y0, x0, h=h, w=w,
                                    channels=channels, tile_h=tile_h,
                                    tile_w=tile_w).numpy()
