"""Postprocessing (counterpart of ``terrain_diffusion_tpu.pipeline.postprocessing``):

- ``local_baseline_temperature``, the climate regression of output
  composition, on tensors;
- the hydrology tools: D8 flow routing and accumulation, priority-flood
  depression filling and river smoothing, host-side numpy and heapq
  (offline tools, not on the serving path), equal to JAX's bit for bit.
"""
from __future__ import annotations

import heapq

import numpy as np
import torch

from terrain_diffusion_tpu_torch.ops.image import avg_pool_stride1


def local_baseline_temperature(T: torch.Tensor, e: torch.Tensor, win: int = 3,
                               beta_clip=(-0.012, 0.0), fallback_beta: float = -0.0065,
                               eps: float = 1e-6, fallback_threshold: float = 0.3):
    """Windowed land-masked regression of temperature on elevation.

    T, e: (..., H, W) temperature [C] and elevation [m], leading dims a
    batch; win: odd window (valid pooling, output cropped by win-1).
    Returns (T_sea, beta), each (..., H-(win-1), W-(win-1)): sea-level
    baseline and local lapse rate.
    """
    w = (e > 0).to(T.dtype)

    def wavg(x):
        num = avg_pool_stride1(x * w, win)
        den = avg_pool_stride1(w, win)
        return num / (den + eps), den

    mu_T, sum_w = wavg(T)
    mu_e, _ = wavg(e)
    mu_e2, _ = wavg(e * e)
    mu_eT, _ = wavg(e * T)
    var_e = mu_e2 - mu_e * mu_e
    cov_eT = mu_eT - mu_e * mu_T
    beta = cov_eT / (var_e + eps)
    invalid = (var_e < 1.0) | (sum_w < fallback_threshold)
    beta = torch.where(invalid, torch.full_like(beta, fallback_beta), beta)
    beta = torch.clamp(beta, beta_clip[0], beta_clip[1])
    pad = (win - 1) // 2
    h, w_ = T.shape[-2:]
    T_c = T[..., pad:h - pad, pad:w_ - pad]
    e_c = e[..., pad:h - pad, pad:w_ - pad]
    return T_c - beta * e_c, beta


# ---------------------------------------------------------------------------
# Hydrology (host-side, offline)
# ---------------------------------------------------------------------------

_D8_OFFSETS = [(-1, -1), (-1, 0), (-1, 1), (0, -1), (0, 1), (1, -1), (1, 0), (1, 1)]
_D8_DIST = np.array([np.sqrt(2), 1, np.sqrt(2), 1, 1, np.sqrt(2), 1, np.sqrt(2)])


def d8_flow(elev: np.ndarray) -> np.ndarray:
    """Steepest-descent D8 flow direction per cell; -1 for pits/flats.

    Returns (H, W) int8 of direction indices into the 8-neighborhood
    (reference `postprocessing.py:6-46` semantics: max drop/distance).
    """
    h, w = elev.shape
    pad = np.pad(elev.astype(np.float64), 1, mode="edge")
    best_drop = np.zeros((h, w))
    best_dir = np.full((h, w), -1, dtype=np.int8)
    for k, (dy, dx) in enumerate(_D8_OFFSETS):
        nb = pad[1 + dy : 1 + dy + h, 1 + dx : 1 + dx + w]
        drop = (elev - nb) / _D8_DIST[k]
        better = drop > best_drop
        best_drop = np.where(better, drop, best_drop)
        best_dir = np.where(better, np.int8(k), best_dir)
    return best_dir


def flow_accumulation(direction: np.ndarray) -> np.ndarray:
    """Cells drained through each cell (inclusive), by topological order."""
    h, w = direction.shape
    acc = np.ones((h, w), dtype=np.int64)
    indeg = np.zeros((h, w), dtype=np.int32)
    tgt = np.full((h, w, 2), -1, dtype=np.int64)
    for y in range(h):
        for x in range(w):
            d = direction[y, x]
            if d >= 0:
                ny, nx = y + _D8_OFFSETS[d][0], x + _D8_OFFSETS[d][1]
                if 0 <= ny < h and 0 <= nx < w:
                    tgt[y, x] = (ny, nx)
                    indeg[ny, nx] += 1
    stack = [(y, x) for y in range(h) for x in range(w) if indeg[y, x] == 0]
    while stack:
        y, x = stack.pop()
        ny, nx = tgt[y, x]
        if ny >= 0:
            acc[ny, nx] += acc[y, x]
            indeg[ny, nx] -= 1
            if indeg[ny, nx] == 0:
                stack.append((ny, nx))
    return acc


def priority_flood_fill(elev: np.ndarray, max_raise: float = np.inf,
                        epsilon: float = 0.0) -> np.ndarray:
    """Priority-flood depression filling with an optional raise cap
    (reference `postprocessing.py:139-260` semantics)."""
    h, w = elev.shape
    out = elev.astype(np.float64).copy()
    visited = np.zeros((h, w), dtype=bool)
    heap = []
    for y in range(h):
        for x in (0, w - 1):
            heapq.heappush(heap, (out[y, x], y, x))
            visited[y, x] = True
    for x in range(1, w - 1):
        for y in (0, h - 1):
            heapq.heappush(heap, (out[y, x], y, x))
            visited[y, x] = True
    while heap:
        z, y, x = heapq.heappop(heap)
        for dy, dx in _D8_OFFSETS:
            ny, nx = y + dy, x + dx
            if 0 <= ny < h and 0 <= nx < w and not visited[ny, nx]:
                visited[ny, nx] = True
                nz = out[ny, nx]
                fill = z + epsilon
                if nz < fill:
                    raised = min(fill, elev[ny, nx] + max_raise)
                    out[ny, nx] = max(nz, raised)
                heapq.heappush(heap, (max(out[ny, nx], z), ny, nx))
    return out.astype(elev.dtype)


def river_bump_smooth(elev: np.ndarray, accumulation: np.ndarray,
                      threshold: int = 100, sigma: float = 1.5) -> np.ndarray:
    """Smooth elevation along high-accumulation (river) cells
    (reference `postprocessing.py:87-135` behavior: blend a blurred copy in
    river neighborhoods)."""
    from scipy.ndimage import gaussian_filter

    rivers = accumulation >= threshold
    if not rivers.any():
        return elev
    blurred = gaussian_filter(elev.astype(np.float64), sigma)
    influence = gaussian_filter(rivers.astype(np.float64), sigma)
    influence = np.clip(influence / max(influence.max(), 1e-9), 0, 1)
    return (elev * (1 - influence) + blurred * influence).astype(elev.dtype)
