"""Streaming (Welford) statistics, used by every dataset builder
(counterpart of ``terrain_diffusion_tpu.data.welford``; host NumPy, float64)."""
from __future__ import annotations

import numpy as np


class Welford:
    """Per-channel streaming mean/std. Channel axis 0 (pass scalars as 1-ch)."""

    def __init__(self, channels: int = 1):
        self.count = np.zeros(channels, np.float64)
        self.mean = np.zeros(channels, np.float64)
        self.m2 = np.zeros(channels, np.float64)

    def update(self, x: np.ndarray):
        """x: (C, ...) batch of values per channel (NaNs ignored)."""
        x = np.asarray(x, np.float64).reshape(x.shape[0], -1)
        for c in range(x.shape[0]):
            v = x[c]
            v = v[~np.isnan(v)]
            if v.size == 0:
                continue
            n = v.size
            bmean = v.mean()
            bm2 = v.var() * n
            delta = bmean - self.mean[c]
            tot = self.count[c] + n
            self.mean[c] += delta * n / tot
            self.m2[c] += bm2 + delta**2 * self.count[c] * n / tot
            self.count[c] = tot

    @property
    def std(self) -> np.ndarray:
        return np.sqrt(self.m2 / np.maximum(self.count, 1))

    def as_attrs(self) -> dict:
        return {"mean": self.mean.tolist(), "std": self.std.tolist(),
                "count": self.count.tolist()}
