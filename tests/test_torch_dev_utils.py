"""The port's dev visualization harness (``dev-viz``) against the JAX
package's, on the CPU.

Both packages run each tool's command on the same HDF5 fixture (JAX's
tests/test_dev_utils.py layout: latents, lowfreq, climate and residual of
two chunks), the same saved models (the port's seeded tiny init with
nonzero gains, saved by the port, loaded by both) and the same seeds.  The
test replaces the ``Browser`` name in each tool module of both packages by
a recorder that keeps the pages, so the panels compare one by one: names,
colour maps and ranges equal, and values within
- 1e-5 max|diff| / max|ref| for the host tools (dataset, noise, windows,
  signed-sqrt; the threefry normals agree within 5e-7, the Laplacian
  composite is a chain of float32 ops);
- 1e-4 for the model tools (autoencoder, base-diffusion with its decoder,
  consistency-decoder, noise-loss-curve: float32 U-Nets in another
  summation order; the port's keys give JAX's draws);
- relative RMSE 1e-3 per panel for pipeline-viz on a tiny world (the
  BASELINE.md bar between implementations).
Each port command also writes its PNGs headless with matplotlib's Agg
backend, and names matplotlib when it cannot render.
"""
import os
import re
import sys

import numpy as np
import pytest
import torch
from click.testing import CliRunner

from terrain_diffusion_tpu.training.dev_utils import curves as jax_curves
from terrain_diffusion_tpu.training.dev_utils import dataset_viz as jax_dataset_viz
from terrain_diffusion_tpu.training.dev_utils import figs as jax_figs
from terrain_diffusion_tpu.training.dev_utils import model_viz as jax_model_viz
from terrain_diffusion_tpu.training.dev_utils import noise_viz as jax_noise_viz

from terrain_diffusion_tpu_torch import __main__ as port_main
from terrain_diffusion_tpu_torch import use_full_f32
from terrain_diffusion_tpu_torch.nn import torch_compat
from terrain_diffusion_tpu_torch.nn.edm_autoencoder import EDMAutoencoder, EDMAutoencoderConfig
from terrain_diffusion_tpu_torch.nn.edm_unet import EDMUnet2D, EDMUnetConfig
from terrain_diffusion_tpu_torch.pipeline.world import WorldPipeline
from terrain_diffusion_tpu_torch.training.dev_utils import curves, dataset_viz, figs
from terrain_diffusion_tpu_torch.training.dev_utils import model_viz, noise_viz
from terrain_diffusion_tpu_torch.training.dev_utils.__main__ import cli as dev_viz

use_full_f32()
HOST_TOL = 1e-5
MODEL_TOL = 1e-4
WORLD_RRMSE = 1e-3
TOOLS = ["dataset", "autoencoder", "base-diffusion", "consistency-decoder", "noise-loss-curve",
         "noise", "pipeline-viz", "windows", "signed-sqrt"]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op torch thread while this module runs (six pytest-xdist
    workers share the CPU)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _lively(model):
    """Block gains 0.3 and out gain 1: the init leaves them 0, which makes
    the networks constant."""
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("emb_gain"):
                p.fill_(0.3)
            elif name == "out_gain":
                p.fill_(1.0)
    return model


def _unet(path, seed, **cfg):
    model = EDMUnet2D(EDMUnetConfig(**cfg), device="cpu",
                      generator=torch.Generator().manual_seed(seed))
    torch_compat.save_model(_lively(model), path)
    return path


UNET = dict(model_channels=8, model_channel_mults=(1, 2), layers_per_block=1,
            attn_resolutions=(), midblock_attention=False, concat_balance=0.5,
            fourier_scale="pos", noise_emb_dims=8, logvar_channels=8)
# tests/helpers.py::tiny_models' configs (decoder tile 64)
WORLD = [dict(UNET, image_size=16, in_channels=11, out_channels=6, model_channel_mults=(1,),
              conditional_inputs=tuple(("float", 8, 0.2) for _ in range(5))),
         dict(UNET, image_size=64, in_channels=5, out_channels=5,
              conditional_inputs=(("tensor", 58, 1.0),)),
         dict(UNET, image_size=64, in_channels=5, out_channels=1, conditional_inputs=())]


@pytest.fixture(scope="module")
def fixture_dir(tmp_path_factory):
    """An HDF5 file of two chunks (latents, lowfreq, climate, residual),
    latents (crop 32) and decoder (crop 64) configs over it, the tiny VAE,
    base and decoder models, and a tiny world directory."""
    import h5py

    root = tmp_path_factory.mktemp("devviz")
    h5 = str(root / "data.h5")
    rng = np.random.default_rng(0)
    with h5py.File(h5, "w") as f:
        for chunk in range(2):
            g = f.create_group(f"90/{chunk}/0")
            d = g.create_dataset("latent", data=rng.standard_normal(
                (8, 8, 96, 96)).astype(np.float16))
            d.attrs["pct_land"] = 0.5
            d.attrs["split"] = "val"
            g.create_dataset("lowfreq", data=rng.standard_normal(
                (96, 96)).astype(np.float32) * 38 - 31)
            g.create_dataset("lowres_exact", data=rng.standard_normal(
                (96, 96)).astype(np.float32) * 100)
            g.create_dataset("climate", data=rng.standard_normal(
                (19, 96, 96)).astype(np.float32))
            r = g.create_dataset("residual", data=rng.standard_normal(
                (768, 768)).astype(np.float32))
            r.attrs["pct_land"] = 0.5
            r.attrs["split"] = "val"
            g.attrs["beauty_score"] = 3.0
    paths = {"h5": h5, "latents": str(root / "latents.cfg"), "decoder": str(root / "dec.cfg")}
    with open(paths["latents"], "w") as f:
        f.write(f"""
[val_dataset]
@dataset=h5_latents
h5_file="{h5}"
crop_size=32
pct_land_ranges=[[0, 1]]
subset_resolutions=[90]
subset_weights=[1.0]
latents_mean=[0, 0, 0, 0]
latents_std=[1, 1, 1, 1]
split="val"
cond_input_mean=[0, 0, 0, 0, 0, 0, 0.5]
cond_input_std=[1, 1, 1, 1, 1, 1, 0.5]
val_dset=true
""")
    with open(paths["decoder"], "w") as f:
        f.write(f"""
[val_dataset]
@dataset=h5_decoder_terrain
h5_file="{h5}"
crop_size=64
pct_land_ranges=[[0, 1]]
subset_resolutions=[90]
split="val"
""")
    ae = EDMAutoencoder(EDMAutoencoderConfig(
        image_size=32, in_channels=5, latent_channels=2, model_channels=8,
        model_channel_mults=(1, 2), layers_per_block=1, midblock_attention=False),
        device="cpu", generator=torch.Generator().manual_seed(1))
    paths["ae"] = str(root / "ae")
    torch_compat.save_model(_lively(ae), paths["ae"])
    # the latents items' conditioning vector at crop 32 has 13 dims
    paths["base"] = _unet(str(root / "base"), 2,
                          **dict(WORLD[1], conditional_inputs=(("tensor", 13, 1.0),)))
    paths["decoder_model"] = _unet(str(root / "decoder_model"), 3, **WORLD[2])
    paths["world"] = str(root / "world")
    g = torch.Generator().manual_seed(7)
    models = [_lively(EDMUnet2D(EDMUnetConfig(**cfg), device="cpu", generator=g))
              for cfg in WORLD]
    WorldPipeline(seed=5, decoder_tile_size=64, decoder_tile_stride=48,
                  device="cpu").set_models(*models).save_pretrained(paths["world"])
    return paths


def _args(tool, p):
    """(JAX module, port module, command attribute, arguments, port takes
    --device) of each tool."""
    return {
        "dataset": (jax_dataset_viz, dataset_viz, "main",
                    ["--config", p["latents"], "--section", "val_dataset", "--n", "2"], True),
        "autoencoder": (jax_model_viz, model_viz, "autoencoder",
                        ["--config", p["latents"], "--model-path", p["ae"], "--n", "2"], True),
        "base-diffusion": (jax_model_viz, model_viz, "base_diffusion",
                           ["--config", p["latents"], "--model-path", p["base"],
                            "--decoder-path", p["decoder_model"], "--n", "1", "--steps", "4"],
                           True),
        "consistency-decoder": (jax_model_viz, model_viz, "consistency_decoder",
                                ["--config", p["decoder"], "--model-path", p["decoder_model"],
                                 "--n", "1"], True),
        "noise-loss-curve": (jax_curves, curves, "main",
                             ["--config", p["latents"], "--model-path", p["base"], "--n", "2",
                              "--points", "3"], True),
        "noise": (jax_noise_viz, noise_viz, "main", ["--size", "64", "--tile", "32"], True),
        "pipeline-viz": (jax_figs, figs, "pipeline_viz",
                         ["--model-path", p["world"], "--size", "32",
                          "--kwarg", "latents_batch_size=[1,2,4]"], True),
        "windows": (jax_figs, figs, "windows", ["--tile", "32", "--stride", "16"], False),
        "signed-sqrt": (jax_figs, figs, "signed_sqrt", [], False),
    }[tool]


def _record(monkeypatch, module) -> list:
    """Replace ``module.Browser`` by a recorder of every page it is given."""
    pages = []

    class Recorder:
        def __init__(self, page_fn, n_pages, out="viz.png", headless=None):
            self.page_fn, self.n_pages = page_fn, n_pages

        def run(self):
            pages.extend(self.page_fn(i) for i in range(self.n_pages))
            return pages

    monkeypatch.setattr(module, "Browser", Recorder)
    return pages


def _numbers_out(text: str) -> str:
    return re.sub(r"[-+]?\d+\.\d+(e[-+]?\d+)?", "#", text)


def _err(got, want, rrmse: bool) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    if rrmse:
        return float(np.sqrt(np.mean((got - want) ** 2)) / max(np.sqrt(np.mean(want ** 2)),
                                                                1e-30))
    return float(np.max(np.abs(got - want)) / max(np.max(np.abs(want)), 1e-30))


def _assert_pages_match(got, want, tol, rrmse=False):
    assert len(got) == len(want) > 0
    for gp, wp in zip(got, want):
        assert _numbers_out(gp.title) == _numbers_out(wp.title)
        assert [p[:2] for p in gp.panels] == [p[:2] for p in wp.panels]
        for (kind, name, g, gcmap, grange), (_, _, w, wcmap, wrange) in zip(gp.panels,
                                                                           wp.panels):
            assert (gcmap, grange) == (wcmap, wrange), name
            if kind == "image":
                assert _err(g, w, rrmse) <= tol, name
            else:
                assert g[2:] == w[2:], name  # labels, log axis
                assert _err(g[0], w[0], False) <= HOST_TOL, name
                assert _err(g[1], w[1], rrmse) <= tol, name


@pytest.mark.parametrize("tool", TOOLS)
def test_tool_pages_match_jax(fixture_dir, monkeypatch, tool):
    """Each tool's command in both packages, pages recorded: the port's
    panels equal JAX's within the tool's bar."""
    jax_mod, port_mod, attr, args, takes_device = _args(tool, fixture_dir)
    want = _record(monkeypatch, jax_mod)
    got = _record(monkeypatch, port_mod)
    jax_args = args + (["--kwarg", "block_impl=xla"] if tool == "pipeline-viz" else [])
    getattr(jax_mod, attr).main(jax_args, standalone_mode=False)
    port_args = args + (["--device", "cpu"] if takes_device else [])
    getattr(port_mod, attr).main(port_args, standalone_mode=False)
    if tool == "pipeline-viz":
        _assert_pages_match(got, want, WORLD_RRMSE, rrmse=True)
    elif tool in ("dataset", "noise", "windows", "signed-sqrt"):
        _assert_pages_match(got, want, HOST_TOL)
    else:
        _assert_pages_match(got, want, MODEL_TOL)
    if tool == "noise":  # the overlap panels prove bit-exact crops in both fields
        overlaps = [p for p in got[0].panels if "overlap" in p[1]]
        assert len(overlaps) == 2 and all(not p[2].any() for p in overlaps)


@pytest.mark.parametrize("tool", TOOLS)
def test_port_tool_writes_its_png_headless(fixture_dir, tmp_path, tool):
    """``python -m terrain_diffusion_tpu_torch dev-viz <tool> ... --headless``
    through the group writes one PNG a page."""
    pytest.importorskip("matplotlib")
    _, _, _, args, takes_device = _args(tool, fixture_dir)
    out = str(tmp_path / "viz.png")
    argv = ["dev-viz", tool, *args, "--out", out, "--headless"]
    argv += ["--device", "cpu"] if takes_device else []
    result = CliRunner().invoke(port_main.cli, argv)
    assert result.exit_code == 0, result.output
    # --n is the pages of the browsers and the samples a point of the curve
    n = int(args[args.index("--n") + 1]) if tool != "noise-loss-curve" and "--n" in args else 1
    paths = [out] if n == 1 else [str(tmp_path / f"viz_{i}.png") for i in range(n)]
    for path in paths:
        assert os.path.getsize(path) > 10_000, path


def test_dataset_contact_sheet(fixture_dir, tmp_path):
    pytest.importorskip("matplotlib")
    sheet = str(tmp_path / "sheet.png")
    out = dataset_viz.main(["--config", fixture_dir["latents"], "--section", "val_dataset",
                            "--n", "2", "--out", sheet, "--sheet", "--device", "cpu"],
                           standalone_mode=False)
    assert out == [sheet] and os.path.getsize(sheet) > 10_000


def test_rendering_without_matplotlib_names_it(fixture_dir, tmp_path, monkeypatch):
    """Without matplotlib the page functions still work, and rendering
    fails with an error that names matplotlib (no silent exit 0)."""
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    page = figs.windows_page(32, 16)(0)
    assert len(page.panels) == 3
    result = CliRunner().invoke(port_main.cli, ["dev-viz", "windows", "--out",
                                                str(tmp_path / "w.png"), "--headless"])
    assert result.exit_code != 0 and "matplotlib" in str(result.exception)
    assert not os.path.exists(tmp_path / "w.png")


def test_group_lists_jax_tools_and_defaults_to_the_card(fixture_dir, monkeypatch):
    """``dev-viz --help`` lists JAX's nine tools; a device tool asked to run
    on a card torch cannot see exits with a usage error naming --device
    cpu, before it loads anything."""
    from terrain_diffusion_tpu.training.dev_utils.__main__ import cli as jax_dev_viz

    assert sorted(dev_viz.commands) == sorted(jax_dev_viz.commands) == sorted(TOOLS)
    result = CliRunner().invoke(port_main.cli, ["dev-viz", "--help"])
    assert result.exit_code == 0 and all(t in result.output for t in TOOLS)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    result = CliRunner().invoke(port_main.cli, ["dev-viz", "consistency-decoder", "--config",
                                                fixture_dir["decoder"], "--model-path",
                                                fixture_dir["decoder_model"]])
    assert result.exit_code == 2 and "--device cpu" in result.output
