"""Dataset browsers (counterpart of
``terrain_diffusion_tpu.training.dev_utils.dataset_viz``): page through
samples of any registry dataset section with per-channel panels,
denormalized views, and - for latents datasets - the decoded-terrain
composite."""
from __future__ import annotations

import click
import numpy as np

from terrain_diffusion_tpu_torch.training.dev_utils import (Browser, Page, decode_terrain,
                                                           load_section, render_contact_sheet)


def _dataset_page(ds, idx: int, show_terrain: bool, device="cpu") -> Page:
    s = ds[idx]
    name = type(ds).__name__
    page = Page(f"{name}[{idx}]  path={s.get('path', '?')}")
    img = np.asarray(s["image"])
    for c in range(img.shape[-1]):
        page.image(f"image[{c}]", img[..., c])
    if s.get("cond_img") is not None:
        ci = np.asarray(s["cond_img"])
        for c in range(ci.shape[-1]):
            page.image(f"cond_img[{c}]", ci[..., c])
    cond_vec = (s.get("cond_inputs") or [None])[0]
    if cond_vec is not None and np.asarray(cond_vec).ndim == 1:
        v = np.asarray(cond_vec)
        page.curve(f"cond_inputs[0] ({v.size}-dim)", np.arange(v.size), v,
                   xlabel="dim", ylabel="value")
    # H5Latents samples: image = [4 latent ch | lowfreq]; show the
    # denormalized lowfreq and (no residual GT at this stage) a lowfreq-only
    # terrain estimate so conditioning bugs are visible in meters
    if show_terrain and img.shape[-1] >= 5 and name == "H5LatentsDataset":
        from terrain_diffusion_tpu_torch.training.datasets.h5_datasets import (LOWFREQ_MEAN,
                                                                               LOWFREQ_STD)

        sigma_data = getattr(ds, "sigma_data", 0.5)
        low = img[..., 4] / sigma_data
        page.image("lowfreq [m^0.5]", low * LOWFREQ_STD + LOWFREQ_MEAN,
                   cmap="terrain")
        page.image("terrain(lowfreq only) [m]",
                   decode_terrain(np.zeros_like(low), low, device=device), cmap="terrain")
    # Decoder/autoencoder samples: image[0] is a normalized residual
    if show_terrain and name in ("H5DecoderTerrainDataset",
                                 "H5AutoencoderDataset"):
        res = img[..., 0]
        page.image("signed_square(residual) [rel m]",
                   np.sign(res) * np.square(res), cmap="terrain")
    return page


@click.command("dataset")
@click.option("--config", "config_path", required=True,
              type=click.Path(exists=True))
@click.option("--section", default="train_dataset")
@click.option("--n", type=int, default=4, help="samples/pages to render")
@click.option("--start", type=int, default=0)
@click.option("--out", default="dataset_viz.png")
@click.option("--sheet", is_flag=True, help="single contact-sheet PNG "
              "instead of per-sample pages")
@click.option("--no-terrain", is_flag=True, help="skip decoded-terrain panels")
@click.option("--headless/--interactive", default=None)
@click.option("-o", "--override", "overrides", multiple=True)
@click.option("--device", default="cuda", show_default=True,
              help="where the decoded-terrain composite runs; --device cpu runs on the CPU")
def main(config_path, section, n, start, out, sheet, no_terrain, headless,
         overrides, device):
    """Browse dataset samples (channels + terrain composites)."""
    from terrain_diffusion_tpu_torch.common.cli_helpers import click_check_device

    click_check_device(device)
    ds = load_section(config_path, section, overrides)
    if sheet:
        render_contact_sheet([ds[start + i] for i in range(n)], out)
        print(f"wrote {out} ({n} samples)")
        return [out]
    return Browser(lambda i: _dataset_page(ds, start + i, not no_terrain, device),
                   n_pages=n, out=out, headless=headless).run()


if __name__ == "__main__":
    main()
