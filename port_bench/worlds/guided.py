"""The guided world: the undistilled base under AutoGuidance in the latent
stage.

Four models: the coarse model (20 DPM-Solver++ steps a window), the base
diffusion model and its guide, a narrower base (``latent_steps`` DPM-Solver++
steps a latent window, each step a forward of both: ``g + s (m - g)``), and
the consistency decoder (one step a window), attached to the port's
``WorldPipeline`` (``latent_sampler="dpm"``) by ``set_models(..., guide=)``;
``reference.guided_world.GuidedRefWorld`` is its plain reference.  What a kind
module defines: ``harness/registry.py::world_kind``.
"""
from __future__ import annotations

from harness.work import unet_forward_flops
from reference.guided_world import GuidedRefWorld
from reference.window import TensorWindow
from reference.world import (COARSE_STRIDE, COARSE_TILE, LATENT_STRIDE, LATENT_TILE,
                             climate_ranges, elev_ranges)

MODELS = {"coarse": "coarse_model", "base": "base_model", "guide": "guide_model",
          "decoder": "decoder_model"}
MODEL_STAGES = ("coarse", "latent_dpm", "decoder")
COARSE_STEPS = 20  # DPM-Solver++ steps of one coarse window


def attach(world, models: dict):
    world.set_models(models["coarse"], models["base"], models["decoder"],
                     guide=models["guide"])


def reference(models: dict, seed: int, world_cfg: dict, device) -> GuidedRefWorld:
    return GuidedRefWorld(models["coarse"], models["base"], models["guide"], models["decoder"],
                          seed, world_cfg, device)


def windows(world_cfg: dict, boxes) -> dict:
    """{stage: set of window indices} that the tiles ``boxes`` need, each
    window once: the decoder windows and latent windows their elevation
    reads, the latent windows under those decoder windows, and the coarse
    windows under the latent windows and the climate reads."""
    lc = world_cfg["latent_compression"]
    dt, ds = world_cfg["decoder_tile_size"], world_cfg["decoder_tile_stride"]
    coarse_win = TensorWindow((7, COARSE_TILE, COARSE_TILE), (7, COARSE_STRIDE, COARSE_STRIDE))
    latent_win = TensorWindow((6, LATENT_TILE, LATENT_TILE), (6, LATENT_STRIDE, LATENT_STRIDE))
    decoder_win = TensorWindow((2, dt, dt), (2, ds, ds))
    coarse_arg = TensorWindow((7, 4, 4), (7, 1, 1), offset=(0, -1, -1))
    latent_arg = TensorWindow((6, dt // lc, dt // lc), (6, ds // lc, ds // lc))
    dec, latent, coarse = set(), set(), set()
    for (i1, j1, i2, j2) in boxes:
        res_r, lat_r, _, _ = elev_ranges(i1, j1, i2, j2, lc)
        dec.update(decoder_win.windows_overlapping(res_r))
        latent.update(latent_win.windows_overlapping(lat_r))
        coarse.update(coarse_win.windows_overlapping(climate_ranges(i1, j1, i2, j2, lc)))
    for d in dec:
        latent.update(latent_win.windows_overlapping(latent_arg.box(d)))
    for s in latent:
        coarse.update(coarse_win.windows_overlapping(coarse_arg.box(s)))
    return {"coarse": coarse, "latent_dpm": latent, "decoder": dec}


def window_flops(model_cfgs: dict, world_cfg: dict) -> dict:
    """FLOPs of one window of each stage: a latent window is ``latent_steps``
    forwards of the base model and, guided, as many of the guide."""
    steps = world_cfg.get("latent_steps", 15)
    step = unet_forward_flops(model_cfgs["base"], 1, LATENT_TILE)
    if world_cfg.get("guidance_scale", 1.5) != 1.0:
        step += unet_forward_flops(model_cfgs["guide"], 1, LATENT_TILE)
    return {"coarse": COARSE_STEPS * unet_forward_flops(model_cfgs["coarse"], 1, COARSE_TILE),
            "latent_dpm": steps * step,
            "decoder": unet_forward_flops(model_cfgs["decoder"], 1,
                                          world_cfg["decoder_tile_size"])}
