"""Multistep DPM-Solver++ (the ODE form) in the EDM formulation: frozen
copy of the port's ``scheduler/dpmsolver.py`` as the coarse stage runs it
(Karras sigmas, order 2, midpoint, lower order at the end, final sigma 0);
scalar coefficients in float32."""
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
               num_steps: int) -> torch.Tensor:
    """Run the full DPM-Solver++ trajectory.

    model_fn(scaled_sample, sigma) -> model output, with sigma a float32
    scalar; x_init is pure noise already scaled by sigmas[0].  For
    ``sde-dpmsolver++``, ``sde_noise`` is the (num_steps, *x.shape) noise,
    one draw a step.
    """
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
        sample = _update(orders[i], ms, sample, s_t, s_s0, s_s1, s_s2, cfg)
    return sample
