"""Evaluation: tiling helpers shared by the bounded-canvas samplers
(counterpart of ``terrain_diffusion_tpu.evaluation``)."""
from __future__ import annotations

import numpy as np

from terrain_diffusion_tpu_torch.ops.windows import linear_weight_window  # noqa: F401


def constant_weight_window(size: int) -> np.ndarray:
    return np.ones((size, size), dtype=np.float32)


def tile_starts(total: int, tile: int, stride: int) -> list[int]:
    """Start offsets covering [0, total) with the given tile and stride;
    the final tile is clamped to the edge."""
    if total <= tile:
        return [0]
    starts = list(range(0, total - tile, stride))
    if starts[-1] != total - tile:
        starts.append(total - tile)
    return starts
