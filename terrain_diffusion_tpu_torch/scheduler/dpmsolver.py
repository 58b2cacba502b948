"""EDM-formulation DPM-Solver++ as a Python loop over tensors.

Counterpart of ``terrain_diffusion_tpu.scheduler.dpmsolver``: Karras /
exponential sigma schedules with the scaling_p/scaling_t warp, EDM
pre-conditioning, TrigFlow noise labels, multistep DPM-Solver++ of
orders 1-3 with lower-order-final logic, and its SDE variant
(``sde-dpmsolver++``, orders 1-2, on caller-given noise).  The per-step solver order is
resolved statically from the step index and config (``_order_schedule``).
Scalar coefficients are computed in float32, as the JAX program computes
them, so both packages scale the sample by the same numbers.  Exponential
terms are sigma ratios, so the final sigma=0 step is finite.  The EDM
pre-conditioning, ``add_noise`` and the AutoGuidance
``scale_score_in_velocity`` work on tensors.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

f32 = np.float32


@dataclasses.dataclass(frozen=True)
class EDMSchedulerConfig:
    sigma_min: float = 0.002
    sigma_max: float = 80.0
    sigma_data: float = 0.5
    scaling_p: Optional[float] = None
    scaling_t: float = 0.05
    sigma_schedule: str = "karras"  # or "exponential"
    rho: float = 7.0
    solver_order: int = 2
    prediction_type: str = "epsilon"  # or "v_prediction"
    algorithm_type: str = "dpmsolver++"  # or "sde-dpmsolver++"
    solver_type: str = "midpoint"  # or "heun"
    lower_order_final: bool = True
    euler_at_final: bool = False
    final_sigmas_type: str = "zero"  # or "sigma_min"


def compute_sigmas(cfg: EDMSchedulerConfig, num_steps: int) -> np.ndarray:
    """num_steps+1 sigmas (descending, final is 0 or sigma_min), computed in
    float32 like the reference's torch arithmetic."""
    ramp = np.linspace(0, 1, num_steps, dtype=f32)
    if cfg.sigma_schedule == "karras":
        min_inv_rho = cfg.sigma_min ** (1 / cfg.rho)
        max_inv_rho = cfg.sigma_max ** (1 / cfg.rho)
        sigmas = (f32(max_inv_rho) + ramp * f32(min_inv_rho - max_inv_rho)) ** f32(cfg.rho)
        if cfg.scaling_p is not None:
            u = (sigmas - f32(cfg.sigma_min)) / f32(cfg.sigma_max - cfg.sigma_min)
            base_scale = np.sqrt(np.maximum(f32(0.0), 1 - u ** f32(cfg.scaling_p)))
            sigmas = sigmas / (base_scale * f32(1 - cfg.scaling_t) + f32(cfg.scaling_t))
    elif cfg.sigma_schedule == "exponential":
        sigmas = np.exp(np.linspace(np.log(cfg.sigma_min), np.log(cfg.sigma_max),
                                    num_steps, dtype=f32))[::-1]
    else:
        raise ValueError(f"unknown sigma_schedule {cfg.sigma_schedule}")
    last = cfg.sigma_min if cfg.final_sigmas_type == "sigma_min" else 0.0
    return np.concatenate([sigmas, [last]]).astype(np.float64)


def trigflow_precondition_noise(sigma, sigma_data: float):
    """arctan(sigma / sigma_data) in float32."""
    return f32(np.arctan(f32(sigma) / f32(sigma_data)))


def init_noise_sigma(cfg: EDMSchedulerConfig) -> float:
    return float((cfg.sigma_max ** 2 + 1) ** 0.5)


def precondition_inputs(sample, sigma, sigma_data: float):
    return sample / torch.sqrt(torch.as_tensor(sigma) ** 2 + sigma_data ** 2)


def precondition_noise(sigma):
    return 0.25 * torch.log(torch.as_tensor(sigma))


def precondition_outputs(sample, model_output, sigma, sigma_data: float,
                         prediction_type: str = "epsilon"):
    sigma = torch.as_tensor(sigma)
    c_skip = sigma_data ** 2 / (sigma ** 2 + sigma_data ** 2)
    c_out = sigma * sigma_data / torch.sqrt(sigma ** 2 + sigma_data ** 2)
    if prediction_type == "v_prediction":
        c_out = -c_out
    return c_skip * sample + c_out * model_output


def add_noise(original, noise, sigma):
    return original + noise * sigma


def scale_score_in_velocity(v0, sample, sigma, model_output, alpha: float = 1.5,
                            sigma_data: float = 0.5, eps: float = 1e-20):
    """AutoGuidance helper: scale only the score-parallel component of a
    velocity, per sample (reference ``dpmsolver.py:27-72``)."""
    sigma = torch.as_tensor(sigma, dtype=sample.dtype, device=sample.device)
    while sigma.dim() < sample.dim():
        sigma = sigma[..., None]
    sigma2 = sigma * sigma
    sd2 = sigma_data * sigma_data
    denoised = (sd2 / (sigma2 + sd2)) * sample \
        + (sigma * sigma_data / torch.sqrt(sigma2 + sd2)) * model_output
    d = denoised - sample
    dims = tuple(range(1, v0.dim()))
    dot_vd = torch.sum(v0 * d, dim=dims, keepdim=True)
    dot_dd = torch.clamp(torch.sum(d * d, dim=dims, keepdim=True), min=eps)
    v_par = (dot_vd / dot_dd) * d
    return (v0 - v_par) + alpha * v_par


def _order_schedule(cfg: EDMSchedulerConfig, num_steps: int) -> list:
    """Static per-step solver order."""
    orders = []
    lower_order_nums = 0
    for i in range(num_steps):
        lower_order_final = (i == num_steps - 1) and (
            cfg.euler_at_final
            or (cfg.lower_order_final and num_steps < 15)
            or cfg.final_sigmas_type == "zero")
        lower_order_second = ((i == num_steps - 2) and cfg.lower_order_final
                              and num_steps < 15)
        if cfg.solver_order == 1 or lower_order_nums < 1 or lower_order_final:
            orders.append(1)
        elif cfg.solver_order == 2 or lower_order_nums < 2 or lower_order_second:
            orders.append(2)
        else:
            orders.append(3)
        if lower_order_nums < cfg.solver_order:
            lower_order_nums += 1
    return orders


def _sde_update(order, ms, sample, s_t, s_s0, s_s1, z, cfg):
    """One sde-dpmsolver++ update of order 1 or 2 with the step's noise z."""
    ratio = f32(s_t / s_s0)  # exp(-h); finite at s_t == 0
    r2 = f32(ratio * ratio)  # exp(-2h)
    one_r2 = f32(f32(1.0) - r2)
    noise = float(f32(s_t * np.sqrt(max(f32(0.0), one_r2))))
    if order == 1:
        return sample * float(r2) + ms[0] * float(one_r2) + z * noise
    st = max(s_t, f32(1e-20))
    h = f32(np.log(f32(s_s0 / st)))
    r0 = f32(f32(np.log(f32(s_s1 / s_s0))) / h)
    m0 = ms[0]
    d1 = (m0 - ms[1]) / float(r0)
    if cfg.solver_type == "midpoint":
        c1 = f32(f32(0.5) * one_r2)
    else:
        c1 = f32(f32(one_r2 / f32(f32(-2.0) * h)) + f32(1.0))
    return sample * float(r2) + m0 * float(one_r2) + d1 * float(c1) + z * noise


def _update(order, ms, sample, s_t, s_s0, s_s1, s_s2, cfg):
    """One multistep DPM-Solver++ update (ms = [m0, m1, m2], newest first)."""
    ratio = f32(s_t / s_s0)  # exp(-h); finite at s_t == 0
    if order == 1:
        return sample * float(ratio) - ms[0] * float(ratio - f32(1.0))
    st = max(s_t, f32(1e-20))
    h = f32(np.log(f32(s_s0 / st)))
    h0 = f32(np.log(f32(s_s1 / s_s0)))
    r0 = f32(h0 / h)
    m0, m1 = ms[0], ms[1]
    if order == 2:
        d1 = (m0 - m1) / float(r0)
        if cfg.solver_type == "midpoint":
            return (sample * float(ratio) - m0 * float(ratio - f32(1.0))
                    - d1 * float(f32(0.5) * (ratio - f32(1.0))))
        return (sample * float(ratio) - m0 * float(ratio - f32(1.0))
                + d1 * float(f32((ratio - f32(1.0)) / h) + f32(1.0)))
    h1 = f32(np.log(f32(s_s2 / s_s1)))
    r1 = f32(h1 / h)
    d1_0 = (m0 - m1) / float(r0)
    d1_1 = (m1 - ms[2]) / float(r1)
    d1 = d1_0 + (d1_0 - d1_1) * float(f32(r0 / f32(r0 + r1)))
    d2 = (d1_0 - d1_1) / float(f32(r0 + r1))
    return (sample * float(ratio) - m0 * float(ratio - f32(1.0))
            + d1 * float(f32((ratio - f32(1.0)) / h) + f32(1.0))
            - d2 * float(f32(f32(ratio - f32(1.0) + h) / f32(h * h)) - f32(0.5)))


def sample_dpm(model_fn: Callable, x_init: torch.Tensor, cfg: EDMSchedulerConfig,
               num_steps: int, sde_noise=None) -> torch.Tensor:
    """Run the full DPM-Solver++ trajectory.

    model_fn(scaled_sample, sigma) -> model output, with sigma a float32
    scalar; x_init is pure noise already scaled by sigmas[0].  For
    ``sde-dpmsolver++``, ``sde_noise`` is the (num_steps, *x.shape) noise,
    one draw a step.
    """
    sde = cfg.algorithm_type == "sde-dpmsolver++"
    if sde:
        if sde_noise is None:
            raise ValueError(
                "sde-dpmsolver++ needs sde_noise (num_steps, *x.shape): "
                "zero noise would silently run a contracted mean update "
                "that is neither the ODE nor the SDE")
        if cfg.solver_order >= 3:
            raise ValueError(
                "sde-dpmsolver++ supports solver_order <= 2 (the order-3 "
                "update has no noise term; the reference raises the same)")
        sde_noise = torch.as_tensor(sde_noise, dtype=x_init.dtype, device=x_init.device)
        if tuple(sde_noise.shape) != (num_steps, *x_init.shape):
            raise ValueError(f"sde_noise is {tuple(sde_noise.shape)}, not "
                             f"{(num_steps, *x_init.shape)}")
    sig = compute_sigmas(cfg, num_steps).astype(f32)
    orders = _order_schedule(cfg, num_steps)
    sd = f32(cfg.sigma_data)
    sample = x_init
    ms = []
    for i in range(num_steps):
        s_t, s_s0 = sig[i + 1], sig[i]
        s_s1 = sig[max(i - 1, 0)]
        s_s2 = sig[max(i - 2, 0)] if i >= 2 else sig[min(i, 1)]
        var = f32(s_s0 * s_s0 + sd * sd)
        c_in = f32(f32(1.0) / np.sqrt(var))
        out = model_fn(sample * float(c_in), s_s0)
        c_skip = f32(sd * sd / var)
        c_out = f32(s_s0 * sd / np.sqrt(var))
        if cfg.prediction_type == "v_prediction":
            c_out = -c_out
        m0 = sample * float(c_skip) + out * float(c_out)
        ms = [m0] + ms[:2]
        if sde:
            sample = _sde_update(orders[i], ms, sample, s_t, s_s0, s_s1, sde_noise[i], cfg)
        else:
            sample = _update(orders[i], ms, sample, s_t, s_s0, s_s1, s_s2, cfg)
    return sample
