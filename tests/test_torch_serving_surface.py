"""The rest of the port's serving surface against the JAX package, on the
CPU: crs, GeoTIFF, relief map, Azgaar import, tiff-export, generate, the
explorer, the random sampler, the command group and model_utils.

The pipelines load one world directory saved by the port from the tiny
models of tests/helpers.py (seeded, nonzero gains), decoder tiles 64/48,
threefry noise, T=2.  Bars:
- crs, Azgaar conversion, GeoTIFF arrays: bit-equal (the same numpy code;
  files cross both ways, float32 and int16, LZW and uncompressed);
- relief map: within 1 of 255 per channel;
- elevation that went through the models (tiff-export, generate, the
  explorer's detail_raw): int16 within 1 m (floor can flip at an integer
  boundary); the explorer's PNGs: pixels within 1; its JSON: the same keys
  and shapes, /api/status equal, numbers within 1e-5 relative plus 0.011
  (one rounding step of the coarse routes, 0.01, and its float32 error):
  the coarse stage's values agree to float32 precision, and coarse
  elevation is squared, so 2e4 m carries about 0.03 m of float32 noise;
- the random sampler's tile centres: equal.
"""
import io
import json
import os
import shutil
from dataclasses import astuple

import click
import numpy as np
import pytest
import torch
from click.testing import CliRunner

from terrain_diffusion_tpu.common import crs as jax_crs
from terrain_diffusion_tpu.common import geotiff as jax_geotiff
from terrain_diffusion_tpu.common import model_utils as jax_model_utils
from terrain_diffusion_tpu.pipeline.world import WorldPipeline as JaxWorldPipeline
from terrain_diffusion_tpu.serving import azgaar_to_tiff as jax_azgaar
from terrain_diffusion_tpu.serving import random_sampler as jax_random_sampler
from terrain_diffusion_tpu.serving import relief_map as jax_relief
from terrain_diffusion_tpu.serving import tiff_export as jax_tiff_export
from terrain_diffusion_tpu.serving.explorer import server as jax_explorer

from terrain_diffusion_tpu_torch import __main__ as port_main
from terrain_diffusion_tpu_torch.common import crs, geotiff, model_utils
from terrain_diffusion_tpu_torch.nn.torch_compat import params_from_jax
from terrain_diffusion_tpu_torch.pipeline import world as world_mod
from terrain_diffusion_tpu_torch.nn.edm_unet import EDMUnet2D, EDMUnetConfig
from terrain_diffusion_tpu_torch.pipeline.world import WorldPipeline
from terrain_diffusion_tpu_torch.runtime.tile_store import HDF5TileStore
from terrain_diffusion_tpu_torch.serving import api, azgaar_to_tiff, random_sampler
from terrain_diffusion_tpu_torch.serving import minecraft_api as mc
from terrain_diffusion_tpu_torch.serving import relief_map, tiff_export
from terrain_diffusion_tpu_torch.serving import world_generator as wg
from terrain_diffusion_tpu_torch.serving.explorer import server as explorer

SEED = 77
KW = dict(latents_batch_size=[1, 2, 4], log_mode="info")
COMMANDS = ["api", "azgaar-to-tiff", "build-base-dataset", "build-encoded-dataset",
            "build-synthetic-stats", "define-splits", "explore", "export", "generate", "latency",
            "mc-api", "onnx-export", "save-model", "tiff-export", "train"]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op torch thread while this module runs (six pytest-xdist
    workers share the CPU)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# tests/helpers.py::tiny_models' configs (decoder tile 64)
TINY = [
    dict(image_size=16, in_channels=11, out_channels=6, model_channels=8,
         model_channel_mults=(1,), layers_per_block=1, attn_resolutions=(),
         midblock_attention=False, concat_balance=0.5,
         conditional_inputs=tuple(("float", 8, 0.2) for _ in range(5)),
         fourier_scale="pos", noise_emb_dims=8, logvar_channels=8),
    dict(image_size=64, in_channels=5, out_channels=5, model_channels=8,
         model_channel_mults=(1, 2), layers_per_block=1, attn_resolutions=(),
         midblock_attention=False, concat_balance=0.5,
         conditional_inputs=(("tensor", 58, 1.0),), fourier_scale="pos",
         noise_emb_dims=8, logvar_channels=8),
    dict(image_size=64, in_channels=5, out_channels=1, model_channels=8,
         model_channel_mults=(1, 2), layers_per_block=1, attn_resolutions=(),
         midblock_attention=False, concat_balance=0.5, conditional_inputs=(),
         fourier_scale="pos", noise_emb_dims=8, logvar_channels=8),
]


@pytest.fixture(scope="module")
def world_dir(tmp_path_factory):
    """A world directory both packages load: the port's seeded tiny models
    with block gains 0.3 and out gain 1 (init leaves them 0: constant
    networks), saved by the port, which spares compiling JAX's init."""
    pytest.importorskip("safetensors")
    path = str(tmp_path_factory.mktemp("world"))
    g = torch.Generator().manual_seed(7)
    models = [EDMUnet2D(EDMUnetConfig(**cfg), device="cpu", generator=g) for cfg in TINY]
    with torch.no_grad():
        for m in models:
            for name, p in m.named_parameters():
                if name.endswith("emb_gain"):
                    p.fill_(0.3)
                elif name == "out_gain":
                    p.fill_(1.0)
    WorldPipeline(seed=SEED, decoder_tile_size=64, decoder_tile_stride=48,
                  device="cpu").set_models(*models).save_pretrained(path)
    return path


@pytest.fixture(scope="module")
def pipes(world_dir):
    port = WorldPipeline.from_pretrained(world_dir, seed=SEED, device="cpu", **KW).bind()
    ref = JaxWorldPipeline.from_pretrained(world_dir, seed=SEED, block_impl="xla", **KW)
    ref.bind()
    return port, ref


def _wsgi(app, path, body=None, method="GET"):
    from urllib.parse import urlsplit

    parts = urlsplit(path)
    environ = {"REQUEST_METHOD": method, "PATH_INFO": parts.path,
               "QUERY_STRING": parts.query, "wsgi.input": io.BytesIO(body or b""),
               "CONTENT_LENGTH": str(len(body or b""))}
    out = {}

    def start_response(status, headers):
        out["status"], out["headers"] = status, dict(headers)

    data = b"".join(app.wsgi(environ, start_response))
    return out["status"], out["headers"], data


def _png_pixels(body) -> np.ndarray:
    from PIL import Image

    assert body[:8] == b"\x89PNG\r\n\x1a\n"
    return np.asarray(Image.open(io.BytesIO(body))).astype(np.int32)


# --- crs, GeoTIFF, relief map, Azgaar ------------------------------------------

@pytest.mark.parametrize("code,lon_range,lat_range", [
    ("EPSG:4326", (-179, 179), (-89, 89)), (32631, (0.1, 5.9), (-79, 83)),
    (32733, (12.1, 17.9), (-79, -1)), (3857, (-179, 179), (-84, 84)),
    (3031, (-179, 179), (-89, -61)), (3413, (-179, 179), (55, 89))])
def test_crs_bit_equal_to_jax(code, lon_range, lat_range):
    rng = np.random.default_rng(abs(hash(str(code))) % 2 ** 32)
    lon, lat = rng.uniform(*lon_range, 300), rng.uniform(*lat_range, 300)
    port, ref = crs.CRS(code), jax_crs.CRS(code)
    assert port.is_geographic == ref.is_geographic
    for got, want in ((port.from_wgs84(lon, lat), ref.from_wgs84(lon, lat)),
                      (port.to_wgs84(*ref.from_wgs84(lon, lat)),
                       ref.to_wgs84(*ref.from_wgs84(lon, lat)))):
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
    assert port.transform_bounds(*lon_range[:1], lat_range[0], lon_range[1], lat_range[1]) == \
        ref.transform_bounds(*lon_range[:1], lat_range[0], lon_range[1], lat_range[1])
    with pytest.raises(crs.UnsupportedCRSError):
        crs.CRS("EPSG:2154")


@pytest.mark.parametrize("compress", ["lzw", None], ids=["lzw", "raw"])
@pytest.mark.parametrize("dtype", [np.float32, np.int16])
@pytest.mark.parametrize("writer,reader", [(geotiff, jax_geotiff), (jax_geotiff, geotiff)],
                         ids=["port_writes", "jax_writes"])
def test_geotiff_files_cross_both_ways(tmp_path, writer, reader, dtype, compress):
    rng = np.random.default_rng(3)
    arr = (rng.standard_normal((21, 34)) * 900).astype(dtype)
    t = writer.Affine.from_bounds(-10, 40, 5, 50, 34, 21)
    path = tmp_path / "f.tif"
    writer.write_geotiff(path, arr, t, crs="EPSG:32633", nodata=-9999.0, compress=compress)
    back, t2, nodata, code = reader.read_geotiff_info(path)
    assert back.dtype == arr.dtype
    np.testing.assert_array_equal(back, arr)
    assert (t2.a, t2.c, t2.e, t2.f) == (t.a, t.c, t.e, t.f)
    assert nodata == -9999.0 and code == "EPSG:32633"
    assert astuple(geotiff.Affine(*astuple(t)).scaled_pixels(256)) == \
        astuple(jax_geotiff.Affine(*astuple(t)).scaled_pixels(256))


def test_relief_map_within_one_of_255():
    yy, xx = np.mgrid[0:96, 0:80].astype(np.float32)
    elev = 1800 * np.sin(xx / 9.0) * np.cos(yy / 7.0) + 300
    elev[5, 7] = np.nan
    biome = (np.arange(96 * 80).reshape(96, 80) % 7).astype(np.int32)
    flow = np.abs(np.sin(xx) * 12).astype(np.float32)
    for kw in ({}, {"resolution": 30.0, "vmin": 0.0, "vmax": 2500.0},
               {"biome": biome, "flow": flow, "relief": 0.6}):
        got = relief_map.get_relief_map(elev, **kw)
        want = jax_relief.get_relief_map(elev, **kw)
        assert got.shape == want.shape == (96, 80, 3)
        g = (np.nan_to_num(got) * 255).astype(np.int32)
        w = (np.nan_to_num(want) * 255).astype(np.int32)
        assert np.abs(g - w).max() <= 1
    np.testing.assert_array_equal(relief_map.biome_palette(), jax_relief.biome_palette())


def test_azgaar_convert_bit_equal(tmp_path):
    verts = [{"i": i, "p": p} for i, p in enumerate(
        [[0, 0], [100, 0], [100, 100], [0, 100], [50, 0], [50, 100], [75, 50]])]
    azg = {
        "info": {"width": 100, "height": 100},
        "mapCoordinates": {"lonW": 0, "lonE": 30, "latS": 30, "latN": 55},
        "settings": {"heightExponent": "1.8"},
        "pack": {"vertices": verts, "cells": [
            {"i": 0, "v": [0, 4, 5, 3], "biome": 0},
            {"i": 1, "v": [4, 1, 6], "biome": 6},
            {"i": 2, "v": [6, 2, 5], "biome": 9}]},
        "grid": {"vertices": verts, "cells": [
            {"i": 0, "v": [0, 4, 5, 3], "h": 10, "temp": 15, "prec": 8},
            {"i": 1, "v": [4, 1, 6], "h": 40, "temp": 22, "prec": 12},
            {"i": 2, "v": [6, 2, 5], "h": 70, "temp": -3}]},
    }
    src = tmp_path / "map.json"
    src.write_text(json.dumps(azg))
    got = azgaar_to_tiff.convert(src, tmp_path / "port", scale=20.0)
    want = jax_azgaar.convert(src, tmp_path / "jax", scale=20.0)
    assert got.keys() == want.keys() and len(got) == 5
    for k in got:
        np.testing.assert_array_equal(got[k], want[k])
        back, _, _ = jax_geotiff.read_geotiff(tmp_path / "port" / f"{k}.tif")
        np.testing.assert_array_equal(back, want[k].astype(np.float32))
    assert got["heightmap"].min() < 0 < got["heightmap"].max()


# --- tiff-export and generate ---------------------------------------------------

def test_tiff_export_matches_jax(world_dir, tmp_path, monkeypatch):
    """tiff-export at 16 px per cell and 2 cells of padding (the JAX package's
    test scale) on a 3x2-cell conditioning set of all five channels."""
    for mod in (tiff_export, jax_tiff_export):
        monkeypatch.setattr(mod, "PIXELS_PER_CELL", 16)
        monkeypatch.setattr(mod, "PADDING", 2)
    tdir = tmp_path / "cond"
    tdir.mkdir()
    rng = np.random.default_rng(5)
    t = geotiff.Affine.from_bounds(0, 0, 2, 3, 2, 3)
    scales = {"heightmap.tif": 900.0, "temperature.tif": 10.0, "temperature_std.tif": 0.05,
              "precipitation.tif": 500.0, "precipitation_cv.tif": 20.0}
    for name, scale in scales.items():
        geotiff.write_geotiff(tdir / name, (np.abs(rng.standard_normal((3, 2))) * scale)
                              .astype(np.float32), t)
    got = tiff_export.export(world_dir, tdir, tmp_path / "port.tif", seed=5, batch_size="1,2,4",
                             chunk_size=32, device="cpu")
    want = jax_tiff_export.export(world_dir, tdir, tmp_path / "jax.tif", seed=5,
                                  batch_size="1,2,4", chunk_size=32, block_impl="xla")
    assert got.dtype == np.int16 and got.shape == want.shape == (48, 32)
    assert np.abs(got.astype(np.int32) - want).max() <= 1 and got.std() > 0
    back, t2, _ = jax_geotiff.read_geotiff(tmp_path / "port.tif")
    np.testing.assert_array_equal(back, got)
    assert astuple(t2) == astuple(t.scaled_pixels(16))


def test_generate_world_matches_jax(world_dir, pipes, tmp_path):
    """The port's generate writes its world file in the JAX layout; read back
    by the port, it gives the JAX world's elevation."""
    out = wg.generate_world(world_dir, hdf5_file=str(tmp_path / "port.h5"), seed=SEED,
                            coarse_window=1, caching_strategy="indirect", tile_size=512,
                            latents_batch_size=[1, 2, 4], log_mode="info", device="cpu")
    # the 512 x 512 walk covers 12 x 12 decoder windows of 64 at stride 48
    assert out["seed"] == SEED and out["decoder_windows"] == 144
    store = HDF5TileStore(str(tmp_path / "port.h5"), mode="r")
    assert len(store.file["init_residual_map"].keys()) == 144
    assert set(store.file.keys()) == {"base_coarse_map", "init_latent_map",
                                      "step_latent_map_0", "init_residual_map"}
    assert store.get_params()["seed"] == SEED
    store.close()
    port = WorldPipeline.from_pretrained(world_dir, seed=SEED, device="cpu", **KW,
                                         caching_strategy="indirect")
    with port.bind(str(tmp_path / "port.h5")):
        q = (-40, 16, 8, 64)
        g = np.floor(port.get(*q, with_climate=False)["elev"])
        assert not any(k in port.stage_timings for k in ("coarse", "decoder"))
    w = np.floor(np.asarray(pipes[1].get(*q, with_climate=False)["elev"]))
    assert np.abs(g - w).max() <= 1 and g.std() > 0


# --- the explorer ------------------------------------------------------------

def _both(pipes, path, **kw):
    port, ref = pipes
    explorer.configure(pipeline=port)
    jax_explorer.configure(pipeline=ref)
    got, want = _wsgi(explorer.app, path, **kw), _wsgi(jax_explorer.app, path, **kw)
    assert got[0] == want[0] and got[0].startswith("200"), (got, want)
    assert got[1]["Content-Type"] == want[1]["Content-Type"]
    return got, want


COARSE = "ci0=-2&ci1=3&cj0=-1&cj1=3"


@pytest.mark.parametrize("path", ["/api/status", f"/api/coarse_data.json?{COARSE}",
                                  f"/api/coarse_stats?{COARSE}"])
def test_explorer_json_routes_match_jax(pipes, path):
    got, want = _both(pipes, path)
    g, w = json.loads(got[2]), json.loads(want[2])
    if path == "/api/status":
        assert g == w
    else:
        _assert_json_close(g, w)


def _assert_json_close(g, w):
    if isinstance(w, dict):
        assert g.keys() == w.keys()
        for k in w:
            _assert_json_close(g[k], w[k])
    elif isinstance(w, list):
        assert len(g) == len(w)
        for a, b in zip(g, w):
            _assert_json_close(a, b)
    elif isinstance(w, (int, float)) and not isinstance(w, bool):
        # 1e-5 relative, plus one rounding step of 0.01 and its float32 error
        assert abs(g - w) <= 1e-5 * abs(w) + 0.011, (g, w)
    else:
        assert g == w


@pytest.mark.parametrize("path", [f"/api/coarse.png?channel=0&{COARSE}",
                                  f"/api/coarse.png?channel=4&{COARSE}&ch0_min=-5000",
                                  "/api/detail.png?ci=0&cj=0&detail_size=24&mode=relief",
                                  "/api/detail.png?ci=0&cj=0&detail_size=24&mode=elevation"])
def test_explorer_png_routes_within_one_of_jax(pipes, path):
    got, want = _both(pipes, path)
    g, w = _png_pixels(got[2]), _png_pixels(want[2])
    assert g.shape == w.shape and np.abs(g - w).max() <= 1
    if "coarse" in path:
        for h in ("X-Vmin", "X-Vmax"):
            g, w = float(got[1][h]), float(want[1][h])
            assert abs(g - w) <= 1e-5 * abs(w) + 1e-3, (h, g, w)


def test_explorer_detail_raw_within_1m_of_jax(pipes):
    path = "/api/detail_raw?ci=0&cj=0&detail_size=24&pan_i=5&pan_j=-3"
    got, want = _both(pipes, path)
    for h in ("X-Height", "X-Width", "X-Has-Temp"):
        assert got[1][h] == want[1][h]
    h, w = int(got[1]["X-Height"]), int(got[1]["X-Width"])
    assert (h, w) == (24, 24) and len(got[2]) == len(want[2]) == h * w * 6
    g = np.frombuffer(got[2][:h * w * 2], "<i2").astype(np.int32)
    r = np.frombuffer(want[2][:h * w * 2], "<i2").astype(np.int32)
    assert np.abs(g - r).max() <= 1 and g.std() > 0
    gt = np.frombuffer(got[2][h * w * 2:], "<f4")
    rt = np.frombuffer(want[2][h * w * 2:], "<f4")
    np.testing.assert_allclose(gt, rt, rtol=1e-3, atol=1e-2)
    # the elevation is the pipeline's own, floored to int16
    port = pipes[0]
    direct = port.get(5 - 12, -3 - 12, 5 + 12, -3 + 12)["elev"]
    np.testing.assert_array_equal(g, np.clip(np.floor(direct), -32768, 32767).ravel())


def test_explorer_page_seed_and_errors(pipes):
    got, want = _both(pipes, "/")
    assert got[2] == want[2] and b"Terrain Explorer" in got[2]
    routes = [r for r in explorer.app.routes() if r.startswith("/api/")]
    assert routes == [r for r in jax_explorer.app.routes() if r.startswith("/api/")]
    assert all(r in got[2].decode() for r in routes)
    port, ref = pipes
    got, want = _both(pipes, "/api/seed", body=b'{"seed": "123"}', method="POST")
    assert json.loads(got[2]) == json.loads(want[2]) == {"seed": "123"}
    got, want = _both(pipes, "/api/detail_raw?ci=1&cj=0&detail_size=16")
    g = np.frombuffer(got[2][:512], "<i2").astype(np.int32)
    assert np.abs(g - np.frombuffer(want[2][:512], "<i2")).max() <= 1
    for p in (port, ref):
        p.change_seed(SEED)
    explorer.configure(pipeline=port)
    jax_explorer.configure(pipeline=ref)
    for path in ("/api/seed", "/api/coarse.png?channel=9"):
        status, _, body = _wsgi(explorer.app, path, body=b"{}", method="POST"
                                if path == "/api/seed" else "GET")
        jstatus, _, jbody = _wsgi(jax_explorer.app, path, body=b"{}", method="POST"
                                  if path == "/api/seed" else "GET")
        assert status == jstatus and status.startswith("400")
        assert json.loads(body).keys() == json.loads(jbody).keys() == {"error"}


def test_random_sampler_centres_equal_jax(pipes):
    port, ref = pipes
    got = list(random_sampler.sample_random_tiles(port, n=2, tile=16, seed=3, separation=512))
    want = list(jax_random_sampler.sample_random_tiles(ref, n=2, tile=16, seed=3,
                                                        separation=512))
    assert [t["center"] for t in got] == [t["center"] for t in want]
    (a0, b0), (a1, b1) = got[0]["center"], got[1]["center"]
    assert max(abs(a0 - a1), abs(b0 - b1)) >= 512
    for g, w in zip(got, want):
        assert g["elev"].shape == (16, 16) and np.isfinite(g["elev"]).all()
        assert np.abs(np.floor(g["elev"]) - np.floor(w["elev"])).max() <= 1


# --- the command group -----------------------------------------------------

def test_group_lists_the_ported_commands():
    assert port_main.cli.list_commands(None) == COMMANDS
    result = CliRunner().invoke(port_main.cli, ["--help"])
    assert result.exit_code == 0
    for name in COMMANDS:
        assert name in result.output
    for name in port_main.cli.lazy_subcommands:
        assert isinstance(port_main.cli.get_command(None, name), click.Command)


@pytest.mark.parametrize("name,module", [("api", api), ("mc-api", mc)])
def test_api_and_mc_api_forward_and_serve_from_the_store(world_dir, tmp_path, monkeypatch,
                                                         name, module):
    seen = {}
    monkeypatch.setattr(module.app, "run", lambda **kw: seen.update(kw))
    h5 = str(tmp_path / "world.h5")
    port_main.cli.main([name, world_dir, "--device", "cpu", "--caching-strategy", "indirect",
                        "--hdf5-file", h5, "--port", "0", "--seed", str(SEED),
                        "--batch-size", "1,2,4", "--log-mode", "info"], standalone_mode=False)
    assert seen["port"] == 0
    pipe = module._get_pipeline()
    assert isinstance(pipe.tile_store, HDF5TileStore) and pipe.tile_store.path == h5
    status, headers, body = _wsgi(module.app, "/terrain?i1=0&j1=0&i2=16&j2=16")
    assert status.startswith("200") and int(headers["X-Height"]) == 16
    assert len(pipe.tile_store.file["init_residual_map"].keys()) > 0
    pipe.close()
    # without --hdf5-file, indirect caching writes a temporary world file
    port_main.cli.main([name, world_dir, "--device", "cpu", "--caching-strategy", "indirect",
                        "--seed", str(SEED)], standalone_mode=False)
    pipe = module._get_pipeline()
    path = pipe._hdf5_file_path
    assert path in world_mod._TEMP_FILES and os.path.exists(path)
    pipe.close()
    assert not os.path.exists(path)
    module.configure()


@pytest.mark.parametrize("argv", [
    ["generate", "w"], ["explore", "w"], ["tiff-export", "w", ".", "out.tif"],
    ["random-sampler", "w", "out"]], ids=["generate", "explore", "tiff-export", "random"])
def test_entry_points_default_to_the_card(monkeypatch, tmp_path, argv):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.chdir(tmp_path)

    def no_loading(*a, **k):
        raise AssertionError("a model was loaded")

    monkeypatch.setattr(WorldPipeline, "from_pretrained", no_loading)
    cmd = random_sampler.main if argv[0] == "random-sampler" else port_main.cli
    result = CliRunner().invoke(cmd, argv[1:] if argv[0] == "random-sampler" else argv)
    assert result.exit_code != 0 and "--device cpu" in result.output
    assert not os.path.exists(tmp_path / "out")


# --- model_utils ------------------------------------------------------------

def test_model_paths_match_jax(tmp_path, monkeypatch):
    assert model_utils.MODEL_PATHS == jax_model_utils.MODEL_PATHS
    monkeypatch.chdir(tmp_path)
    for name in model_utils.MODEL_PATHS:
        assert model_utils.get_default_model_path(name) == \
            jax_model_utils.get_default_model_path(name)
    for args in (("mine", "a", "b"), (None, str(tmp_path), "hub"), (None, "absent", "hub")):
        assert model_utils.resolve_model_path(*args) == jax_model_utils.resolve_model_path(*args)


@pytest.mark.parametrize("sigma_rel", [None, 0.1], ids=["raw", "ema"])
def test_get_model(world_dir, tmp_path, sigma_rel):
    ckpt = tmp_path / "ckpt"
    shutil.copytree(os.path.join(world_dir, "decoder_model"), ckpt / "saved_model")
    jmodel, jparams = jax_model_utils.get_model(str(ckpt))
    model = model_utils.get_model(str(ckpt), device="cpu")
    want = params_from_jax(model, jparams)
    state = model.state_dict()
    assert all(torch.equal(state[k], want[k].reshape(state[k].shape)) for k in want)
    if sigma_rel is None:
        return
    with pytest.raises(FileNotFoundError, match="phema"):
        model_utils.get_model(str(ckpt), sigma_rel=sigma_rel, device="cpu")
    from terrain_diffusion_tpu_torch.training.phema import PostHocEMA

    (ckpt / "phema").mkdir()
    names = [n for n, _ in model.named_parameters()][:3]
    g = torch.Generator().manual_seed(1)
    for sr in (0.05, 0.1):
        for step in (10, 20):
            torch.save({n: torch.randn(state[n].shape, generator=g) for n in names},
                       ckpt / "phema" / f"{sr}.{step}.pt")
    ema = model_utils.get_model(str(ckpt), sigma_rel=sigma_rel, ema_step=20, device="cpu")
    synth = PostHocEMA.synthesize_from_folder(str(ckpt / "phema"), sigma_rel, 20)
    got = ema.state_dict()
    assert all(torch.equal(got[n], synth[n]) for n in names)
    assert all(torch.equal(got[k], state[k]) for k in state if k not in names)
