"""Save an inference model, optionally post-hoc EMA, from a training
checkpoint (counterpart of ``terrain_diffusion_tpu/training/save_model.py``).

``python -m terrain_diffusion_tpu_torch.training.save_model <checkpoint_dir>
[--sigma-rel 0.1] [--step N] [--out DIR]`` writes ``<checkpoint_dir>/saved_model_ema/``
(or ``--out``) in the reference format (config.json + model.safetensors),
which ``nn/torch_compat.load_model``, both servers and the JAX package load.
"""
from __future__ import annotations

import os

import click

from terrain_diffusion_tpu_torch.nn import torch_compat
from terrain_diffusion_tpu_torch.training.phema import PostHocEMA


def save_model(checkpoint_dir: str, sigma_rel: float | None = None, step: int | None = None,
               out: str | None = None) -> str:
    """The checkpoint's weights, or with ``sigma_rel`` the EMA synthesized
    from ``phema/`` beside or inside the checkpoint, as a saved model;
    returns its directory."""
    model = torch_compat.load_model(os.path.join(checkpoint_dir, "saved_model"), device="cpu")
    if sigma_rel is not None:
        phema_dir = os.path.join(checkpoint_dir, "..", "phema")
        if not os.path.isdir(phema_dir):
            phema_dir = os.path.join(checkpoint_dir, "phema")
        model.load_state_dict(PostHocEMA.synthesize_from_folder(phema_dir, sigma_rel, step),
                              strict=False)
        print(f"Synthesized EMA sigma_rel={sigma_rel} from {phema_dir}")
    out = out or os.path.join(checkpoint_dir, "saved_model_ema")
    torch_compat.save_model(model, out)
    print(f"Saved model to {out}")
    return out


@click.command()
@click.argument("checkpoint_dir", type=click.Path(exists=True))
@click.option("--sigma-rel", type=float, default=None,
              help="EMA length to synthesize (post-hoc); omit to save raw weights")
@click.option("--step", type=int, default=None, help="snapshot step cutoff for synthesis")
@click.option("--out", default=None, help="output directory")
def main(checkpoint_dir, sigma_rel, step, out):
    """Save an inference model (optionally post-hoc EMA) from a checkpoint."""
    save_model(checkpoint_dir, sigma_rel, step, out)


if __name__ == "__main__":
    main()
