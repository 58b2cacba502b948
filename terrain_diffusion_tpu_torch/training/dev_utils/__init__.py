"""Dev visualization harness (counterpart of
``terrain_diffusion_tpu.training.dev_utils``): dataset, model and pipeline
viewers that page through numpy panels.

Every tool is headless-first: it renders one PNG per page (over SSH, in CI,
on a card machine without a display), and browses pages with next / prev
buttons when a display is present.  One command line:

    python -m terrain_diffusion_tpu_torch.training.dev_utils <tool> [options]
    python -m terrain_diffusion_tpu_torch dev-viz <tool> [options]

Tools: dataset, autoencoder, base-diffusion, consistency-decoder,
noise-loss-curve, noise, pipeline-viz, windows, signed-sqrt.  Those that run
a model, the threefry field or the terrain composite take ``--device`` (the
card by default; pass ``--device cpu`` without one).  Each tool's pages come from a function that
needs neither click nor matplotlib (``autoencoder_pages``,
``pipeline_viz_page``, ...); only ``Page.render`` and ``Browser.run`` touch
matplotlib, which they import when they render.
"""
from __future__ import annotations

import os

import numpy as np
import torch


def _mpl(headless: bool):
    try:
        import matplotlib
    except ImportError as e:
        raise RuntimeError("dev-viz renders its pages with matplotlib, which is not "
                           "installed; the page functions (e.g. autoencoder_pages) "
                           "build the panels without it") from e

    if headless or not os.environ.get("DISPLAY"):
        matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


class Page:
    """One figure page: a grid of named image/curve panels."""

    def __init__(self, title: str):
        self.title = title
        self.panels: list[tuple] = []

    def image(self, name: str, data, cmap=None, vrange=None):
        self.panels.append(("image", name, np.asarray(data), cmap, vrange))
        return self

    def curve(self, name: str, x, y, xlabel="", ylabel="", logx=False):
        self.panels.append(("curve", name, (np.asarray(x), np.asarray(y),
                                            xlabel, ylabel, logx), None, None))
        return self

    def render(self, plt, ncols: int | None = None):
        n = len(self.panels)
        ncols = ncols or min(n, 4)
        nrows = -(-n // ncols)
        fig, axes = plt.subplots(nrows, ncols,
                                 figsize=(3.2 * ncols, 3.2 * nrows),
                                 squeeze=False)
        fig.suptitle(self.title, fontsize=12)
        for i in range(nrows * ncols):
            ax = axes[i // ncols][i % ncols]
            if i >= n:
                ax.axis("off")
                continue
            kind, name, data, cmap, vrange = self.panels[i]
            if kind == "image":
                kw = {}
                if vrange is not None:
                    kw = {"vmin": vrange[0], "vmax": vrange[1]}
                im = ax.imshow(data, cmap=cmap or "viridis", **kw)
                fig.colorbar(im, ax=ax, fraction=0.046)
                ax.set_xticks([])
                ax.set_yticks([])
            else:
                x, y, xlabel, ylabel, logx = data
                (ax.semilogx if logx else ax.plot)(x, y)
                ax.set_xlabel(xlabel)
                ax.set_ylabel(ylabel)
                ax.grid(True, alpha=0.3)
            ax.set_title(name, fontsize=9)
        fig.tight_layout(rect=(0, 0, 1, 0.96))
        return fig


class Browser:
    """Page browser: interactive (next/prev matplotlib buttons) with a
    display, else renders `n_pages` PNGs."""

    def __init__(self, page_fn, n_pages: int, out: str = "viz.png",
                 headless: bool | None = None):
        self.page_fn = page_fn  # (index) -> Page
        self.n_pages = n_pages
        self.out = out
        self.headless = (headless if headless is not None
                         else not os.environ.get("DISPLAY"))

    def run(self):
        plt = _mpl(self.headless)
        if self.headless:
            base, ext = os.path.splitext(self.out)
            written = []
            for i in range(self.n_pages):
                fig = self.page_fn(i).render(plt)
                path = f"{base}_{i}{ext}" if self.n_pages > 1 else self.out
                fig.savefig(path, dpi=110)
                plt.close(fig)
                written.append(path)
                print(f"wrote {path}")
            return written

        from matplotlib.widgets import Button

        state = {"i": 0, "fig": None}

        def show(i):
            # build the NEW figure before closing the old one: some GUI
            # backends (TkAgg) end the blocking mainloop when the last
            # window closes, which would quit the browser mid-page
            old = state["fig"]
            fig = self.page_fn(i).render(plt)
            if old is not None:
                plt.close(old)
            fig.subplots_adjust(bottom=0.12)
            ax_prev = fig.add_axes([0.35, 0.02, 0.12, 0.05])
            ax_next = fig.add_axes([0.53, 0.02, 0.12, 0.05])
            b_prev, b_next = Button(ax_prev, "Prev"), Button(ax_next, "Next")
            b_prev.on_clicked(lambda _e: show((state["i"] - 1) % self.n_pages))
            b_next.on_clicked(lambda _e: show((state["i"] + 1) % self.n_pages))
            fig._buttons = (b_prev, b_next)  # keep refs alive
            state.update(i=i, fig=fig)
            fig.canvas.draw_idle()
            plt.show()

        show(0)


def load_section(config_path: str, section: str, overrides=()):
    """Resolve one section of a registry config (dataset, model, ...)."""
    from terrain_diffusion_tpu_torch.training.registry import (apply_overrides,
                                                               build_registry,
                                                               load_config, resolve)

    build_registry()
    config = load_config(config_path)
    apply_overrides(config, list(overrides))
    return resolve(config)[section]


def decode_terrain(residual_norm, lowfreq_norm, *, residual_std=1.1678,
                   residual_mean=0.0, device="cpu") -> np.ndarray:
    """(H, W) terrain meters from normalized residual + lowfreq maps, the
    composite every visualizer shows (Laplacian denoise + decode, then the
    signed square, as in the pipeline's elevation composition), computed in
    float32 on ``device``."""
    from terrain_diffusion_tpu_torch.ops.image import signed_square
    from terrain_diffusion_tpu_torch.ops.laplacian import laplacian_decode, laplacian_denoise
    from terrain_diffusion_tpu_torch.training.datasets.h5_datasets import (LOWFREQ_MEAN,
                                                                           LOWFREQ_STD)

    def f32(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    with torch.no_grad():
        res = f32(residual_norm) * residual_std + residual_mean
        low = f32(lowfreq_norm) * LOWFREQ_STD + LOWFREQ_MEAN
        r, lo = laplacian_denoise(res[None], low[None], sigma=5)
        return signed_square(laplacian_decode(r, lo)[0]).cpu().numpy()


def render_contact_sheet(samples: list[dict], out_path: str,
                         max_channels: int = 8):
    """Grid PNG: one row per sample, one column per channel (`dataset
    --sheet` uses it)."""
    plt = _mpl(True)
    rows = len(samples)
    panels = []
    for s in samples:
        cols = []
        img = np.asarray(s["image"])
        for c in range(min(img.shape[-1], max_channels)):
            cols.append((f"img[{c}]", img[..., c]))
        if s.get("cond_img") is not None:
            ci = np.asarray(s["cond_img"])
            for c in range(min(ci.shape[-1], max_channels - len(cols))):
                cols.append((f"cond[{c}]", ci[..., c]))
        panels.append(cols)
    ncols = max(len(p) for p in panels)
    fig, axes = plt.subplots(rows, ncols, figsize=(2.2 * ncols, 2.2 * rows),
                             squeeze=False)
    for r, cols in enumerate(panels):
        for c in range(ncols):
            ax = axes[r][c]
            ax.axis("off")
            if c < len(cols):
                name, data = cols[c]
                ax.imshow(data, cmap="terrain")
                if r == 0:
                    ax.set_title(name, fontsize=8)
    fig.tight_layout()
    fig.savefig(out_path, dpi=110)
    plt.close(fig)
