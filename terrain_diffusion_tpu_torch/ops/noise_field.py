"""Deterministic, O(1)-random-access tiled Gaussian noise fields.

Counterpart of the portable path of ``terrain_diffusion_tpu.ops.noise_field``:
per-tile PCG64+Marsaglia streams seeded by ``tile_seed(base, ty, tx)``.  The
value at (c, y, x) depends only on the seed and the tile it falls in, so any
crop is computable in isolation and overlapping crops agree bit for bit.
The counter-based threefry field of the JAX package is not ported yet.
"""
from __future__ import annotations

import numpy as np

from terrain_diffusion_tpu_torch.ops.rng_portable import fill_standard_normal, tile_seed


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


def seed_to_pair(seed: int) -> np.ndarray:
    """(2,) uint32 [lo, hi] representation of a 64-bit seed."""
    seed = int(seed) & 0xFFFFFFFFFFFFFFFF
    return np.asarray([seed & 0xFFFFFFFF, seed >> 32], dtype=np.uint32)
