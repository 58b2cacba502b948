"""Direct evaluator of the guided 90 m world: the undistilled base under
AutoGuidance in the latent stage, window by window, in float32.

The world of ``RefWorld`` (its coarse stage, decoder, composition and wire
packing, unchanged) with the T=2 consistency phases replaced by one latent
window: ``latent_steps`` multistep DPM-Solver++ steps (``sampler.sample_dpm``
on the coarse stage's EDM schedule: Karras sigmas, sigma_min 0.002, sigma_max
80, sigma_data 0.5, rho 7) from sigma_max times the threefry field at
``seed + 5819`` (5 channels), each step's denoiser the AutoGuidance
combination ``g + guidance_scale * (m - g)`` of the main base model ``m`` and
the guide ``g`` on the same EDM-preconditioned input, both conditioned on
the window's 58-dim vector from its 4x4 coarse context.  The sample is
divided by sigma_data, weighted by the linear window and blended with its
neighbours; the decoder reads that blend as it reads the T=2 latents.

The published sampler (``sample_base_diffusion`` with ``tile_size=64``,
``guide_model=``, ``guidance_scale=``) blends its tiles once on a bounded
canvas, with one noise draw for the canvas; here the windows lie on the
world's infinite grid, with the world's tiled noise field, and are blended
once (the single blend per window), the one departure.  The window is the
stage that ``RefWorld`` calls ``step`` (its parent the coarse map alone), so
its ``tile`` and decoder read it unchanged; there is no ``init`` stage.
It imports neither JAX nor either terrain package.
"""
from __future__ import annotations

import torch

from .sampler import compute_sigmas, sample_dpm, trigflow_precondition_noise
from .window import TensorWindow
from .world import LATENT_STRIDE, LATENT_TILE, SCHED, SD, RefWorld


class GuidedRefWorld(RefWorld):
    """The guided world of ``seed`` over the reference U-Nets ``coarse``,
    ``base`` (the main model), ``guide`` (or None: the base alone) and
    ``decoder``, with the world settings ``cfg`` (the keys of the port's
    ``WorldPipeline.get_config`` of a ``latent_sampler="dpm"`` world)."""

    def __init__(self, coarse, base, guide, decoder, seed: int, cfg: dict, device):
        if cfg.get("latent_sampler") != "dpm":
            raise ValueError("GuidedRefWorld evaluates a latent_sampler='dpm' world; "
                             f"got latent_sampler={cfg.get('latent_sampler')!r}")
        super().__init__(coarse, base, decoder, seed, cfg, device)
        self.models["guide"] = guide
        self.steps = int(cfg.get("latent_steps", 15))
        self.scale = float(cfg.get("guidance_scale", 1.5))
        for d in (self.win, self.cache, self.evaluated, self.seconds):
            d.pop("init")
        coarse_arg = TensorWindow((7, 4, 4), (7, 1, 1), offset=(0, -1, -1))
        self.parents["step"] = (("coarse", coarse_arg),)
        del self.parents["init"]

    def _step(self, ctxs, coarse):
        B, T = len(ctxs), LATENT_TILE
        z = self._noise(self.seed + 5819, ctxs[:, 1] * LATENT_STRIDE,
                        ctxs[:, 2] * LATENT_STRIDE, T, T, 5, T)
        x = z * float(compute_sigmas(SCHED, self.steps)[0])
        cond = [self._cond(coarse)]
        main, guide = self.models["base"], self.models["guide"]
        guided = guide is not None and self.scale != 1.0

        def model_fn(scaled, sigma):
            label = torch.full((B,), float(trigflow_precondition_noise(sigma, SD)),
                               device=self.device)
            x_in = scaled.permute(0, 2, 3, 1)
            out = main(x_in, label, cond)
            if guided:
                g = guide(x_in, label, cond)
                out = g + self.scale * (out - g)
            return out.permute(0, 3, 1, 2)

        return self._weighted(sample_dpm(model_fn, x, SCHED, self.steps) / SD, T)
