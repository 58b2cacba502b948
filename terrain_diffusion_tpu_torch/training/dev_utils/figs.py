"""Paper-figure tools (counterpart of
``terrain_diffusion_tpu.training.dev_utils.figs``): stage-by-stage pipeline
visualization on a bound world, blend-window geometry, and the signed-sqrt
dynamic-range transform."""
from __future__ import annotations

import click
import numpy as np

from terrain_diffusion_tpu_torch.training.dev_utils import Browser, Page

COARSE_NAMES = ["elev_ss", "p5_ss", "temp", "temp_std", "precip", "precip_cv"]


def pipeline_viz_page(world, seed: int, center=(0, 0), size: int = 512):
    """Page function of ``pipeline-viz`` on a bound ``WorldPipeline``: one
    ``get`` of the ``size`` x ``size`` box at ``center``, then the coarse,
    latent and residual windows around it read through ``__getitem__``
    (each a host array, as JAX returns it)."""
    ci, cj = center
    half = size // 2
    i1, j1, i2, j2 = ci - half, cj - half, ci + half, cj + half
    lc = world.latent_compression

    o = world.get(i1, j1, i2, j2)
    coarse = world.coarse[:, i1 // (32 * lc) - 2:i2 // (32 * lc) + 2,
                          j1 // (32 * lc) - 2:j2 // (32 * lc) + 2]
    coarse_n = coarse[:-1] / np.maximum(coarse[-1:], 1e-8)
    lat = world.latents[:, i1 // lc:i2 // lc, j1 // lc:j2 // lc]
    lat_n = lat[:-1] / np.maximum(lat[-1:], 1e-8)
    res = world.residual[:, i1:i2, j1:j2]
    res_n = res[0] / np.maximum(res[1], 1e-8)

    def page(_i):
        p = Page(f"pipeline stages @ ({ci},{cj})  seed={seed}")
        for c in range(coarse_n.shape[0]):
            p.image(f"coarse {COARSE_NAMES[c]}", coarse_n[c], cmap="terrain")
        for c in range(4):
            p.image(f"latent[{c}]", lat_n[c])
        p.image("latent lowfreq", lat_n[4], cmap="terrain")
        p.image("decoder residual", res_n, cmap="terrain")
        p.image("elevation [m]", o["elev"], cmap="terrain")
        p.image("temperature [C]", o["climate"][0], cmap="coolwarm")
        p.image("precip [mm]", o["climate"][2], cmap="Blues")
        return p

    return page


@click.command("pipeline-viz")
@click.option("--model-path", required=True, help="pretrained pipeline dir")
@click.option("--seed", type=int, default=548)
@click.option("--center", type=int, nargs=2, default=(0, 0))
@click.option("--size", type=int, default=512)
@click.option("--out", default="pipeline_viz.png")
@click.option("--headless/--interactive", default=None)
@click.option("--kwarg", "extra_kwargs", multiple=True)
@click.option("--device", default="cuda", show_default=True,
              help="--device cpu runs on the CPU")
def pipeline_viz(model_path, seed, center, size, out, headless, extra_kwargs, device):
    """Every stage of one world query: coarse channels, latents, residual,
    composed elevation + climate."""
    from terrain_diffusion_tpu_torch.common.cli_helpers import click_check_device, parse_kwargs
    from terrain_diffusion_tpu_torch.pipeline.world import WorldPipeline

    click_check_device(device)
    world = WorldPipeline.from_pretrained(
        model_path, seed=seed, device=device, **parse_kwargs(extra_kwargs))
    world.bind()
    with world:
        written = Browser(pipeline_viz_page(world, seed, center, size), n_pages=1, out=out,
                          headless=headless).run()
        print(world.timing_summary())
    return written


def windows_page(tile: int, stride: int):
    """Page function of ``windows`` (host numpy)."""
    from terrain_diffusion_tpu_torch.ops.windows import linear_weight_window

    w = np.asarray(linear_weight_window(tile))
    span = 3 * stride + tile
    cover = np.zeros((span, span))
    n = (span - tile) // stride + 1
    for i in range(n):
        for j in range(n):
            cover[i * stride:i * stride + tile,
                  j * stride:j * stride + tile] += w

    def page(_i):
        p = Page(f"blend windows  tile={tile} stride={stride}")
        p.image("linear weight window", w, cmap="viridis")
        p.curve("center row profile", np.arange(tile), w[tile // 2],
                xlabel="x", ylabel="weight")
        p.image("summed coverage (interior flat)", cover, cmap="viridis")
        interior = cover[tile:-tile, tile:-tile]
        if interior.size:
            print(f"interior coverage: min={interior.min():.6f} "
                  f"max={interior.max():.6f} (flat => exact average)")
        return p

    return page


@click.command("windows")
@click.option("--tile", type=int, default=64)
@click.option("--stride", type=int, default=32)
@click.option("--out", default="windows_viz.png")
@click.option("--headless/--interactive", default=None)
def windows(tile, stride, out, headless):
    """Blend-window geometry: the separable linear weight window, the
    overlap pattern, and the flat (=constant) total coverage that makes
    overlap-blending an exact average."""
    return Browser(windows_page(tile, stride), n_pages=1, out=out, headless=headless).run()


def signed_sqrt_page():
    """Page function of ``signed-sqrt`` (host numpy)."""
    rng = np.random.default_rng(0)
    # bimodal hypsometric mix: abyssal plains + continental platform
    elev = np.concatenate([
        rng.normal(-4000, 1200, 70_000),   # ocean floor
        rng.normal(300, 500, 28_000),      # land
        rng.normal(5000, 1500, 2_000),     # high mountains
    ])
    tr = np.sign(elev) * np.sqrt(np.abs(elev))
    x = np.linspace(-9000, 9000, 1001)

    def page(_i):
        p = Page("signed-sqrt transform: sign(h) * sqrt(|h|)")
        p.curve("transform", x, np.sign(x) * np.sqrt(np.abs(x)),
                xlabel="elevation [m]", ylabel="transformed")
        h1, e1 = np.histogram(elev, bins=120)
        p.curve("raw hypsometry", (e1[:-1] + e1[1:]) / 2, h1,
                xlabel="elevation [m]", ylabel="count")
        h2, e2 = np.histogram(tr, bins=120)
        p.curve("transformed hypsometry", (e2[:-1] + e2[1:]) / 2, h2,
                xlabel="signed sqrt [m^0.5]", ylabel="count")
        print(f"raw std={elev.std():.1f} m; transformed std={tr.std():.2f}; "
              f"range compression x{elev.std() / tr.std():.1f}")
        return p

    return page


@click.command("signed-sqrt")
@click.option("--out", default="signed_sqrt_viz.png")
@click.option("--headless/--interactive", default=None)
def signed_sqrt(out, headless):
    """The signed-sqrt elevation transform: curve + the dynamic-range
    compression on an Earth-like bimodal hypsometry."""
    return Browser(signed_sqrt_page(), n_pages=1, out=out, headless=headless).run()


if __name__ == "__main__":
    pipeline_viz()
