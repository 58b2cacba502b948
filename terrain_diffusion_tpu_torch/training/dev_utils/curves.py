"""Per-noise-level loss curve (counterpart of
``terrain_diffusion_tpu.training.dev_utils.curves``): a trained diffusion
model's raw v-MSE and its uncertainty-weighted loss on a sigma grid over
dataset samples - the quickest read on which part of the noise schedule a
checkpoint has (not) learned.  The forwards run on the model's device under
``torch.no_grad()``; sigma k draws its noise from the k-th split of
``key_from_seed(seed)``, as JAX's tool splits ``jax.random.key(seed)``."""
from __future__ import annotations

import click
import numpy as np
import torch

from terrain_diffusion_tpu_torch.training.dev_utils import Browser, Page, load_section

f32 = np.float32


def noise_loss_curve(model, batch: dict, sigmas, seed: int, sigma_data: float = 0.5):
    """(v-MSE, weighted loss, mean logvar) lists, one entry a sigma, of
    ``model`` on the collated ``batch`` (numpy ``image``, optional
    ``cond_img`` and ``cond_inputs``)."""
    from terrain_diffusion_tpu_torch.ops.noise_field import key_from_seed, normal, split

    dev = next(model.parameters()).device
    images = torch.as_tensor(batch["image"], device=dev)
    cond_inputs = [torch.as_tensor(c, device=dev) for c in batch.get("cond_inputs", [])]
    cond_img = (torch.as_tensor(batch["cond_img"], device=dev)
                if batch.get("cond_img") is not None else None)
    sd = f32(sigma_data)
    mses, weighteds, logvars = [], [], []
    key = key_from_seed(seed)
    for s in sigmas:
        key, sub = split(key)
        t = f32(np.arctan(f32(s) / sd))
        ct, st = float(f32(np.cos(t))), float(f32(np.sin(t)))
        with torch.no_grad():
            noise = normal(sub, images.shape, dev) * float(sd)
            x = (images * ct + noise * st) / float(sd)
            if cond_img is not None:
                x = torch.cat([x, cond_img], dim=-1)
            nl = torch.full((images.shape[0],), float(t), device=dev)
            output, logvar = model(x, nl, cond_inputs, return_logvar=True)
            pred_v = output * -float(sd)
            v_t = noise * ct - images * st
            se = (pred_v - v_t) ** 2
            weighted = (1.0 / (torch.exp(logvar) * float(sd) ** 2)) * se + logvar
            mses.append(float(se.mean()))
            weighteds.append(float(weighted.mean()))
            logvars.append(float(logvar.mean()))
        print(f"sigma={s:9.4f}  v-MSE={mses[-1]:.5f}  "
              f"weighted={weighteds[-1]:.5f}  logvar={logvars[-1]:.3f}")
    return mses, weighteds, logvars


def curve_page(sigmas, mses, weighteds, logvars, n: int):
    """Page function of ``noise-loss-curve``: the three curves over sigma."""

    def page(_i):
        p = Page(f"noise-loss curve  ({n} samples/point)")
        p.curve("raw v-MSE", sigmas, mses, xlabel="sigma", ylabel="MSE",
                logx=True)
        p.curve("uncertainty-weighted loss", sigmas, weighteds,
                xlabel="sigma", ylabel="loss", logx=True)
        p.curve("learned logvar", sigmas, logvars, xlabel="sigma",
                ylabel="logvar", logx=True)
        return p

    return page


def sigma_grid(sigma_min: float, sigma_max: float, points: int) -> np.ndarray:
    return np.exp(np.linspace(np.log(sigma_min), np.log(sigma_max), points))


@click.command("noise-loss-curve")
@click.option("--config", "config_path", required=True,
              type=click.Path(exists=True))
@click.option("--model-path", required=True)
@click.option("--section", default="val_dataset")
@click.option("--n", type=int, default=16, help="samples averaged per sigma")
@click.option("--sigma-min", type=float, default=2e-3)
@click.option("--sigma-max", type=float, default=80.0)
@click.option("--points", type=int, default=24)
@click.option("--sigma-data", type=float, default=0.5)
@click.option("--out", default="noise_loss_curve.png")
@click.option("--seed", type=int, default=548)
@click.option("--headless/--interactive", default=None)
@click.option("-o", "--override", "overrides", multiple=True)
@click.option("--device", default="cuda", show_default=True,
              help="--device cpu runs on the CPU")
def main(config_path, model_path, section, n, sigma_min, sigma_max, points,
         sigma_data, out, seed, headless, overrides, device):
    """Loss vs sigma curve for a trained diffusion model."""
    from terrain_diffusion_tpu_torch.common.cli_helpers import click_check_device
    from terrain_diffusion_tpu_torch.nn import torch_compat
    from terrain_diffusion_tpu_torch.training.datasets import collate

    click_check_device(device)
    ds = load_section(config_path, section, overrides)
    model = torch_compat.load_model(model_path, device=device)
    sigmas = sigma_grid(sigma_min, sigma_max, points)
    curves = noise_loss_curve(model, collate([ds[i] for i in range(n)]), sigmas, seed,
                              sigma_data)
    return Browser(curve_page(sigmas, *curves, n), n_pages=1, out=out,
                   headless=headless).run()


if __name__ == "__main__":
    main()
