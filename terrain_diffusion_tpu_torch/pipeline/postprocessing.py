"""Climate regression used by output composition (counterpart of
``terrain_diffusion_tpu.pipeline.postprocessing.local_baseline_temperature``).
"""
from __future__ import annotations

import torch

from terrain_diffusion_tpu_torch.ops.image import avg_pool_stride1


def local_baseline_temperature(T: torch.Tensor, e: torch.Tensor, win: int = 3,
                               beta_clip=(-0.012, 0.0), fallback_beta: float = -0.0065,
                               eps: float = 1e-6, fallback_threshold: float = 0.3):
    """Windowed land-masked regression of temperature on elevation.

    T, e: (H, W) temperature [C] and elevation [m]; win: odd window (valid
    pooling, output cropped by win-1).  Returns (T_sea, beta), each
    (H-(win-1), W-(win-1)): sea-level baseline and local lapse rate.
    """
    T = T[None]
    e = e[None]
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
    T_c = T[:, pad:T.shape[1] - pad, pad:T.shape[2] - pad]
    e_c = e[:, pad:e.shape[1] - pad, pad:e.shape[2] - pad]
    return (T_c - beta * e_c)[0], beta[0]
