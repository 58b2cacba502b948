"""The T=2 consistency world, the kind of a configuration that names none.

Three models: the coarse model (20 DPM-Solver++ steps a window), the
consistency base (an init step and one intermediate step a latent window)
and the consistency decoder (one step a window), attached to the port's
``WorldPipeline`` by ``set_models``; ``reference.world.RefWorld`` is its plain
reference. What a kind module defines: ``harness/registry.py::world_kind``.
"""
from __future__ import annotations

from harness.work import unet_forward_flops
from reference.window import TensorWindow
from reference.world import (COARSE_STRIDE, COARSE_TILE, LATENT_STRIDE, LATENT_TILE, RefWorld,
                             climate_ranges, elev_ranges)

MODELS = {"coarse": "coarse_model", "base": "base_model", "decoder": "decoder_model"}
MODEL_STAGES = ("coarse", "latent_init", "latent_step", "decoder")
COARSE_STEPS = 20  # DPM-Solver++ steps of one coarse window


def attach(world, models: dict):
    world.set_models(models["coarse"], models["base"], models["decoder"])


def reference(models: dict, seed: int, world_cfg: dict, device) -> RefWorld:
    return RefWorld(models["coarse"], models["base"], models["decoder"], seed, world_cfg, device)


def windows(world_cfg: dict, boxes) -> dict:
    """{stage: set of window indices} that the tiles ``boxes`` need, each
    window once: the decoder windows and step windows their elevation reads,
    the init windows under those, the coarse windows under both latent
    phases and the climate reads."""
    lc = world_cfg["latent_compression"]
    dt, ds = world_cfg["decoder_tile_size"], world_cfg["decoder_tile_stride"]
    coarse_win = TensorWindow((7, COARSE_TILE, COARSE_TILE), (7, COARSE_STRIDE, COARSE_STRIDE))
    latent_win = TensorWindow((6, LATENT_TILE, LATENT_TILE), (6, LATENT_STRIDE, LATENT_STRIDE))
    decoder_win = TensorWindow((2, dt, dt), (2, ds, ds))
    coarse_arg = TensorWindow((7, 4, 4), (7, 1, 1), offset=(0, -1, -1))
    latent_arg = TensorWindow((6, dt // lc, dt // lc), (6, ds // lc, ds // lc))
    dec, step, coarse = set(), set(), set()
    for (i1, j1, i2, j2) in boxes:
        res_r, lat_r, _, _ = elev_ranges(i1, j1, i2, j2, lc)
        dec.update(decoder_win.windows_overlapping(res_r))
        step.update(latent_win.windows_overlapping(lat_r))
        coarse.update(coarse_win.windows_overlapping(climate_ranges(i1, j1, i2, j2, lc)))
    for d in dec:
        step.update(latent_win.windows_overlapping(latent_arg.box(d)))
    init = {w for s in step for w in latent_win.windows_overlapping(latent_win.box(s))}
    for s in step | init:
        coarse.update(coarse_win.windows_overlapping(coarse_arg.box(s)))
    return {"coarse": coarse, "latent_init": init, "latent_step": step, "decoder": dec}


def window_flops(model_cfgs: dict, world_cfg: dict) -> dict:
    """FLOPs of one window of each stage."""
    base = unet_forward_flops(model_cfgs["base"], 1, LATENT_TILE)
    return {"coarse": COARSE_STEPS * unet_forward_flops(model_cfgs["coarse"], 1, COARSE_TILE),
            "latent_init": base, "latent_step": base,
            "decoder": unet_forward_flops(model_cfgs["decoder"], 1,
                                          world_cfg["decoder_tile_size"])}
