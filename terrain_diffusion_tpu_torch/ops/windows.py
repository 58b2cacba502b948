"""Overlap-blending weight windows (counterpart of
``terrain_diffusion_tpu.ops.windows``).

The infinite-tensor runtime sums weighted window outputs plus a weight
channel; consumers divide values by weight to recover the blended average.
"""
from __future__ import annotations

import numpy as np


def linear_weight_window(size: int, eps: float = 1e-3, dtype=np.float32) -> np.ndarray:
    """(size, size) separable linear window: 1 at center, eps at edges."""
    mid = (size - 1) / 2
    r = np.arange(size, dtype=np.float64)
    w1 = 1 - (1 - eps) * np.clip(np.abs(r - mid) / mid, 0, 1)
    return (w1[:, None] * w1[None, :]).astype(dtype)
