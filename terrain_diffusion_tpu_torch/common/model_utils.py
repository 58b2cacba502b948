"""Model path resolution and checkpoint loading (counterpart of
``terrain_diffusion_tpu.common.model_utils``).

``MODEL_PATHS`` names the published checkpoints by hub id; nothing here
downloads them.  A checkpoint is a reference-format directory
(config.json + model.safetensors), which ``nn/torch_compat.load_model``
reads.
"""
from __future__ import annotations

import os

# Local-checkpoint defaults -> published weight ids.
MODEL_PATHS = {
    "coarse": ("checkpoints/models/diffusion_coarse",
               "xandergos/TerrainDiffusion-Diffusion-Coarse-128A"),
    "base": ("checkpoints/models/consistency_base-192x3",
             "xandergos/TerrainDiffusion-Consistency-Base-192x3"),
    "decoder": ("checkpoints/models/consistency_decoder-64x3",
                "xandergos/TerrainDiffusion-Consistency-Decoder-64x3"),
    "diffusion_base": ("checkpoints/models/diffusion_base-192x3",
                       "xandergos/TerrainDiffusion-Diffusion-Base-192x3"),
    "diffusion_base_guide": ("checkpoints/models/diffusion_base-128x3",
                             "xandergos/TerrainDiffusion-Diffusion-Base-128x3"),
}


def resolve_model_path(user_path: str | None, local_default: str, hub_id: str) -> str:
    """user override -> local default -> hub id."""
    if user_path is not None:
        return user_path
    if os.path.exists(local_default):
        return local_default
    return hub_id


def get_default_model_path(name: str) -> str:
    local, hub = MODEL_PATHS[name]
    return local if os.path.exists(local) else hub


def get_model(checkpoint_path: str, sigma_rel: float | None = None,
              ema_step: int | None = None, *, device="cuda"):
    """The model of a checkpoint (its ``saved_model/`` when there is one) on
    ``device``; with ``sigma_rel``, its weights are the post-hoc EMA
    synthesized from the ``phema/`` snapshots beside or inside it."""
    from terrain_diffusion_tpu_torch.nn import torch_compat
    from terrain_diffusion_tpu_torch.training.phema import PostHocEMA

    saved = os.path.join(checkpoint_path, "saved_model")
    model = torch_compat.load_model(saved if os.path.isdir(saved) else checkpoint_path,
                                    device=device)
    if sigma_rel is not None:
        cands = (os.path.join(checkpoint_path, "..", "phema"),
                 os.path.join(checkpoint_path, "phema"))
        for cand in cands:
            if os.path.isdir(cand):
                model.load_state_dict(
                    PostHocEMA.synthesize_from_folder(cand, sigma_rel, ema_step), strict=False)
                break
        else:
            # the raw weights when an EMA was asked for would pass unnoticed
            raise FileNotFoundError(
                f"sigma_rel={sigma_rel} requested but no phema snapshots at "
                f"{cands[0]} or {cands[1]}")
    return model
