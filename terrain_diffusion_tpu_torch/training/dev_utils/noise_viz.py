"""Noise-field visualizer (counterpart of
``terrain_diffusion_tpu.training.dev_utils.noise_viz``): crops of the
deterministic tiled Gaussian fields, with the product invariant shown on
screen - overlapping crops from different window alignments are
bit-identical, tile seams are invisible - for both providers (threefry,
drawn on ``--device``, and the portable PCG64 host field)."""
from __future__ import annotations

import click
import numpy as np

from terrain_diffusion_tpu_torch.training.dev_utils import Browser, Page


def noise_page(seed: int, size: int, tile: int, mode: str, device):
    """The page function of ``noise``: field, overlap |diff|, a crop at
    negative coordinates and the per-row std of each provider."""
    from terrain_diffusion_tpu_torch.ops.noise_field import (gaussian_noise_patch,
                                                             threefry_noise_patch)

    providers = []
    if mode in ("threefry", "both"):
        providers.append(("threefry", lambda s, y, x, h, w: threefry_noise_patch(
            int(s) & 0xFFFFFFFFFFFFFFFF, y, x, h=h, w=w, channels=1, tile_h=tile,
            tile_w=tile, device=device)[0].cpu().numpy()))
    if mode in ("portable", "both"):
        providers.append(("portable", lambda s, y, x, h, w: gaussian_noise_patch(
            s, y, x, h, w, channels=1, tile_h=tile, tile_w=tile)[0]))

    def page(_i):
        p = Page(f"noise fields  seed={seed}  tile={tile}")
        for name, fn in providers:
            field = fn(seed, 0, 0, size, size)
            p.image(f"{name} field", field, cmap="gray")
            # overlap consistency: crop straddling tile boundaries and
            # negative coords must match the big field bit-exactly
            y0, x0 = tile // 2, tile // 2
            crop = fn(seed, y0, x0, tile, tile)
            diff = np.abs(crop - field[y0:y0 + tile, x0:x0 + tile])
            p.image(f"{name} overlap |diff| (max={diff.max():.1e})", diff,
                    cmap="magma", vrange=(0, 1e-6))
            neg = fn(seed, -size // 2, -size // 2, size, size)
            p.image(f"{name} negative-coord crop", neg, cmap="gray")
            # spectrum sanity: per-row std ~1 everywhere (no tile banding)
            p.curve(f"{name} row std", np.arange(size), field.std(axis=1),
                    xlabel="row", ylabel="std")
            print(f"{name}: overlap max|diff| = {diff.max():.3e}  "
                  f"mean={field.mean():+.4f} std={field.std():.4f}")
        return p

    return page


@click.command("noise")
@click.option("--seed", type=int, default=548)
@click.option("--size", type=int, default=192)
@click.option("--tile", type=int, default=64)
@click.option("--mode", type=click.Choice(["threefry", "portable", "both"]),
              default="both")
@click.option("--out", default="noise_viz.png")
@click.option("--headless/--interactive", default=None)
@click.option("--device", default="cuda", show_default=True,
              help="where the threefry field is drawn; --device cpu runs on the CPU")
def main(seed, size, tile, mode, out, headless, device):
    """Visualize deterministic tiled noise fields + overlap consistency."""
    from terrain_diffusion_tpu_torch.common.cli_helpers import click_check_device

    click_check_device(device)
    return Browser(noise_page(seed, size, tile, mode, device), n_pages=1, out=out,
                   headless=headless).run()


if __name__ == "__main__":
    main()
