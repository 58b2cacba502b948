"""The port's data preparation against the JAX package, on the CPU: the
synthetic-map stats cache and its builder, Welford, the equal-area grid,
per-cell elevation preprocessing, the base, encoded and raw dataset
builders, the splits, the beauty scores and the statistics commands.

Inputs are GeoTIFFs written from a seed with the port's ``write_geotiff``
(a global ETOPO-like raster at 1 degree, 19 WorldClim-like layers at 2
degrees, DEM cells of 80x80 with voids, some cells missing), at
``highres_size=64``, ``lowres_size=16``, two chunks a side and
``cell_size_m=4e6`` (24 grid cells).  The VAE has ``model_channels=8`` and
two levels.  Bars:
- stats cache, synthetic maps with the cache, Welford, the grid, splits,
  raw datasets, statistics commands, ``lowres_exact``, climate,
  ``pct_land`` and ids: equal (the same host numpy code);
- ``compute_map_stats``: float64 within 1e-12 relative;
- residual and lowfreq (the Laplacian encode, torch against XLA), dataset
  stats attrs, beauty scores, ``extract_mask_from_tiffs``: within 1e-5
  relative (max|diff| / max|ref|);
- fp16 latents: within one fp16 step of the larger value, or within 1e-5
  of the subchunk's largest latent (near zero an fp16 step is finer than
  the float32 encode's own error at the latents' scale);
- the stats attrs: stds within 1e-5 relative, means within 1e-5 of their
  std (a mean near zero has no relative precision).
"""
import csv
import os
import shutil

import h5py
import numpy as np
import pytest
import torch
from click.testing import CliRunner

from terrain_diffusion_tpu.data import calculate_stats as jax_calc
from terrain_diffusion_tpu.data import welford as jax_welford
from terrain_diffusion_tpu.data import world_grid as jax_grid
from terrain_diffusion_tpu.data.preprocessing import beauty_score as jax_beauty
from terrain_diffusion_tpu.data.preprocessing import build_base_dataset as jax_base
from terrain_diffusion_tpu.data.preprocessing import build_encoded_dataset as jax_encoded
from terrain_diffusion_tpu.data.preprocessing import build_raw_dataset as jax_raw
from terrain_diffusion_tpu.data.preprocessing import define_splits as jax_splits
from terrain_diffusion_tpu.data.preprocessing import elevation as jax_elevation
from terrain_diffusion_tpu.nn import torch_compat as jax_compat
from terrain_diffusion_tpu.pipeline import synthetic_map as jax_sm

from terrain_diffusion_tpu_torch import __main__ as port_main
from terrain_diffusion_tpu_torch import use_full_f32
from terrain_diffusion_tpu_torch.common.geotiff import Affine, write_geotiff
from terrain_diffusion_tpu_torch.data import calculate_stats, welford, world_grid
from terrain_diffusion_tpu_torch.data.default_stats import default_stats
from terrain_diffusion_tpu_torch.data.preprocessing import (beauty_score, build_base_dataset,
                                                            build_encoded_dataset,
                                                            build_raw_dataset, define_splits,
                                                            elevation)
from terrain_diffusion_tpu_torch.nn import torch_compat
from terrain_diffusion_tpu_torch.nn.edm_autoencoder import EDMAutoencoder, EDMAutoencoderConfig
from terrain_diffusion_tpu_torch.pipeline import synthetic_map

use_full_f32()
TOL = 1e-5
SIZES = dict(highres_size=64, lowres_size=16, num_chunks=2)
CELL_M = 4e6
FM = [1.5, 3, 3, 3, 3]
PARAMS = {"drop_water_pct": 0.5, "frequency_mult": FM}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op torch thread while this module runs (six pytest-xdist
    workers share the CPU)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


def _field(rng, shape, scale, offset=0.0, waves=6):
    """A smooth seeded field: a sum of random plane waves."""
    yy, xx = np.meshgrid(np.linspace(0, 1, shape[0]), np.linspace(0, 1, shape[1]),
                         indexing="ij")
    out = np.zeros(shape)
    for _ in range(waves):
        fy, fx = rng.uniform(0.5, 4.0, 2)
        out += np.sin(2 * np.pi * (fy * yy + fx * xx) + rng.uniform(0, 2 * np.pi))
    return (offset + scale * out / np.sqrt(waves)).astype(np.float32)


@pytest.fixture(scope="module")
def rasters(tmp_path_factory):
    """Seeded inputs of the dataset builders: ``etopo.tif`` (global, 1 degree,
    ocean below zero), ``climate/`` (19 bio layers, 2 degrees, a nodata
    patch), ``dem/`` (MERIT cells 0-9 and 12, one all void, voids elsewhere;
    Copernicus cells 0-3, zero = void), ``raw/`` (four small rasters)."""
    root = tmp_path_factory.mktemp("rasters")
    rng = np.random.default_rng(2026)
    write_geotiff(root / "etopo.tif", _field(rng, (180, 360), 3000.0, -1500.0),
                  Affine.from_bounds(-180, -90, 180, 90, 360, 180))
    (root / "climate").mkdir()
    for i in range(1, 20):
        layer = _field(rng, (90, 180), 20.0, 10.0 * i)
        layer[40:50, 60:80] = -3.4e38
        write_geotiff(root / "climate" / f"wc2.1_30s_bio_{i}.tif", layer,
                      Affine.from_bounds(-180, -90, 180, 90, 180, 90), nodata=-3.4e38)
    (root / "dem").mkdir()
    for i in list(range(10)) + [12]:
        dem = _field(rng, (80, 80), 900.0, 300.0 if i % 3 else -200.0)
        if i == 3:
            dem[:] = -9999.0
        elif i % 2:
            dem[10:30, 40:70] = -9999.0
        write_geotiff(root / "dem" / f"dem_{i}.tif", dem)
    for i in range(4):
        dem = _field(rng, (72, 72), 700.0, 400.0)
        dem[:, :12] = 0.0
        write_geotiff(root / "dem" / f"copernicus_{i}.tif", dem)
    (root / "raw").mkdir()
    for i in range(4):
        arr = _field(rng, (40 + 8 * i, 48), 500.0, 100.0)
        arr[3:6, 3:9] = -32768.0
        write_geotiff(root / "raw" / f"tile_{i}.tif", arr, nodata=-32768.0)
    return root


def _base_kwargs(rasters, climate=True):
    return dict(highres_elevation_folder=str(rasters / "dem"),
                lowres_elevation_file=str(rasters / "etopo.tif"),
                climate_folder=str(rasters / "climate") if climate else None, **SIZES)


# --- the synthetic-map stats cache (repair) ---------------------------------

def _cache_stats(drop_water_pct=0.5):
    """Stats unlike the built-in tables: shifted data quantiles and climate fit."""
    stats = {k: np.array(v) if isinstance(v, np.ndarray) else v
             for k, v in default_stats(drop_water_pct).items()}
    for i in range(5):
        q = stats[f"base_image_quantiles_{i}"]
        stats[f"base_image_quantiles_{i}"] = q * 1.25 + 3.0
    stats.update(a_temp_std=-21.5, b_temp_std=990.0, temp_std_p1=-250.0, temp_std_p99=700.0)
    return stats


def _tables(stats):
    return {k: np.asarray(v, np.float64).tolist() if isinstance(v, np.ndarray) else v
            for k, v in stats.items()}


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_stats_cache_crosses_both_ways(tmp_path, writer):
    stats, path = _cache_stats(), str(tmp_path / "stats.json")
    save = jax_sm.save_stats_cache if writer == "jax" else synthetic_map.save_stats_cache
    save(stats, path, params=PARAMS)
    got = synthetic_map.load_stats_cache(path, expect_params=PARAMS)
    want = jax_sm.load_stats_cache(path, expect_params=PARAMS)
    assert got is not None and _tables(got) == _tables(want)
    assert all(np.array_equal(got[f"base_image_quantiles_{i}"],
                              stats[f"base_image_quantiles_{i}"]) for i in range(5))


@pytest.mark.parametrize("where", ["stats_path", "default_path"])
def test_factory_reads_the_cache_as_jax_does(tmp_path, monkeypatch, where):
    stats = _cache_stats()
    if where == "default_path":
        monkeypatch.chdir(tmp_path)
        path = synthetic_map.STATS_CACHE_PATH
        assert path == jax_sm.STATS_CACHE_PATH
        kw = {}
    else:
        path = str(tmp_path / "cache.json")
        kw = {"stats_path": path}
    jax_sm.save_stats_cache(stats, path, params=PARAMS)
    args = dict(seed=1234, frequency_mult=FM, drop_water_pct=0.5)
    got = synthetic_map.make_synthetic_map_factory(**args, **kw)
    want = jax_sm.make_synthetic_map_factory(**args, **kw)
    plain = synthetic_map.make_synthetic_map_factory(**args, stats=default_stats(0.5))
    for box in [(0, 0, 48, 48), (-40, 96, 8, 130)]:
        np.testing.assert_array_equal(got(*box), want(*box))
        assert not np.array_equal(got(*box), plain(*box))


def test_a_cache_of_other_params_is_ignored_by_both(tmp_path):
    path = str(tmp_path / "cache.json")
    jax_sm.save_stats_cache(_cache_stats(0.3), path,
                            params={"drop_water_pct": 0.3, "frequency_mult": FM})
    assert synthetic_map.load_stats_cache(path, expect_params=PARAMS) is None
    assert jax_sm.load_stats_cache(path, expect_params=PARAMS) is None
    args = dict(seed=99, frequency_mult=FM, drop_water_pct=0.5, stats_path=path)
    got = synthetic_map.make_synthetic_map_factory(**args)(0, 0, 32, 32)
    want = jax_sm.make_synthetic_map_factory(**args)(0, 0, 32, 32)
    plain = synthetic_map.make_synthetic_map_factory(
        seed=99, frequency_mult=FM, drop_water_pct=0.5, stats=default_stats(0.5))(0, 0, 32, 32)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, plain)


@pytest.fixture(scope="module")
def global_rasters(tmp_path_factory):
    """ETOPO and four WorldClim layers at 3 degrees, with nodata and -32768 holes."""
    root = tmp_path_factory.mktemp("global")
    rng = np.random.default_rng(7)
    shape = (60, 120)
    t = Affine.from_bounds(-180, -90, 180, 90, shape[1], shape[0])
    fields = {"elev": _field(rng, shape, 3000.0, -1000.0), "temp": _field(rng, shape, 12.0, 10.0),
              "temp_std": _field(rng, shape, 300.0, 700.0),
              "precip": np.abs(_field(rng, shape, 900.0, 600.0)),
              "precip_cv": np.abs(_field(rng, shape, 30.0, 60.0))}
    fields["temp"][20:24, 30:40] = -3.4e38
    fields["temp_std"][30:33, 70:75] = -32768.0
    for name, arr in fields.items():
        write_geotiff(root / synthetic_map.RASTER_FILES[name], arr, t,
                      nodata=-3.4e38 if name != "elev" else None)
    return root


def test_compute_map_stats_and_the_command(global_rasters, tmp_path):
    got = synthetic_map.compute_map_stats(FM, 0.5, str(global_rasters))
    want = jax_sm.compute_map_stats(FM, 0.5, str(global_rasters))
    assert sorted(got) == sorted(want)
    for k in want:
        assert _rel(got[k], want[k]) < 1e-12, k
    out = str(tmp_path / "stats.json")
    result = CliRunner().invoke(port_main.cli, ["build-synthetic-stats", "--data-dir",
                                                str(global_rasters), "--out", out])
    assert result.exit_code == 0, result.output
    cached = jax_sm.load_stats_cache(out, expect_params=PARAMS)
    assert cached is not None and _tables(cached) == _tables(got)
    with open(out) as f:
        assert '"params": {"drop_water_pct": 0.5, "frequency_mult": [1.5, 3.0' in f.read()


# --- Welford and the grid ---------------------------------------------------

def test_welford_and_grid_equal():
    rng = np.random.default_rng(3)
    got, want = welford.Welford(3), jax_welford.Welford(3)
    for n in (5, 17, 1):
        x = rng.standard_normal((3, n, 4)) * 10 + 2
        x[1, 0, 0] = np.nan
        x[2] = np.nan if n == 1 else x[2]
        got.update(x)
        want.update(x)
    for a in ("count", "mean", "m2", "std"):
        np.testing.assert_array_equal(getattr(got, a), getattr(want, a))
    assert got.as_attrs() == want.as_attrs()
    for size in (CELL_M, 368640.0):
        assert world_grid.create_equal_area_grid((size, size)) == \
            jax_grid.create_equal_area_grid((size, size))
    assert len(world_grid.create_equal_area_grid((CELL_M, CELL_M))) == 24
    assert world_grid.cell_id(17) == jax_grid.cell_id(17)


# --- per-cell preprocessing -------------------------------------------------

def _check_subchunks(got, want):
    assert [c["subchunk_id"] for c in got] == [c["subchunk_id"] for c in want]
    for g, w in zip(got, want):
        assert g["chunk_id"] == w["chunk_id"] and g["pct_land"] == w["pct_land"]
        assert _rel(g["residual"], w["residual"]) < TOL
        assert _rel(g["lowfreq"], w["lowfreq"]) < TOL
        np.testing.assert_array_equal(g["lowres_exact"], w["lowres_exact"])
        assert g["residual"].dtype == np.float32 and g["lowfreq"].dtype == np.float32
        if w["climate"] is None:
            assert g["climate"] is None
        else:
            np.testing.assert_array_equal(g["climate"], w["climate"])


@pytest.mark.parametrize("chunk_id,source,margin,climate", [
    ("1", "merit", 0, True), ("3", "merit", 0, True), ("20", "merit", 0, True),
    ("2", "copernicus", 2, False)], ids=["voids", "all-void", "no-file", "copernicus-margin"])
def test_process_single_cell_matches_jax(rasters, chunk_id, source, margin, climate):
    bounds = world_grid.create_equal_area_grid((CELL_M, CELL_M))[int(chunk_id)]
    kw = _base_kwargs(rasters, climate)
    args = (chunk_id, bounds, kw.pop("highres_elevation_folder"),
            kw.pop("lowres_elevation_file"), kw.pop("highres_size"), kw.pop("lowres_size"), 5.0)
    kw.update(edge_margin=margin, data_source=source)
    got = elevation.process_single_cell(*args, **kw, device="cpu")
    want = jax_elevation.process_single_cell(*args, **kw)
    assert len(got) == 4
    _check_subchunks(got, want)


def test_extract_mask_from_tiffs_matches_jax(tmp_path):
    rng = np.random.default_rng(11)
    utm = _field(rng, (60, 50), 400.0, 800.0)
    utm[:4, :4] = -9999.0
    write_geotiff(tmp_path / "utm.tif", utm, Affine(1000.0, 0.0, 480000.0, 0.0, -1000.0,
                                                    5300000.0), crs="EPSG:32633", nodata=-9999.0)
    geo = _field(rng, (40, 40), 300.0, 500.0)
    write_geotiff(tmp_path / "geo.tif", geo, Affine.from_bounds(14.0, 47.0, 16.0, 49.0, 40, 40))
    (tmp_path / "mosaic").mkdir()
    for k, x0 in enumerate((14.0, 15.0)):
        write_geotiff(tmp_path / "mosaic" / f"m{k}.tif", _field(rng, (20, 20), 100.0, 50.0),
                      Affine.from_bounds(x0, 47.0, x0 + 1.0, 48.0, 20, 20))
    for name, bounds in [("utm.tif", (14.8, 47.4, 15.2, 47.7)),
                         ("geo.tif", (14.3, 47.5, 15.1, 48.2)),
                         ("mosaic", (14.5, 47.2, 15.5, 47.8))]:
        got = elevation.extract_mask_from_tiffs(tmp_path / name, bounds)
        want = jax_elevation.extract_mask_from_tiffs(tmp_path / name, bounds)
        assert got.shape == want.shape and got.dtype == np.float32
        np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
        ok = ~np.isnan(want)
        assert ok.any() and _rel(got[ok], want[ok]) < TOL


# --- the dataset builders, end to end ---------------------------------------

def _walk(f):
    """{path: (array, attrs)} of every dataset, and {path: attrs} of every group."""
    dsets, groups = {}, {}

    def visit(name, obj):
        if isinstance(obj, h5py.Dataset):
            dsets[name] = (obj[()], dict(obj.attrs))
        else:
            groups[name] = dict(obj.attrs)

    f.visititems(visit)
    groups["/"] = dict(f.attrs)
    return dsets, groups


def _same_attrs(got, want):
    """Strings equal; numbers within TOL relative, a mean within TOL of its
    std (a mean near zero has no relative precision)."""
    assert sorted(got) == sorted(want)
    for k in want:
        if isinstance(want[k], (str, bytes)):
            assert got[k] == want[k], k
        elif k.endswith("_mean"):
            scale = np.abs(np.asarray(want[k[:-len("_mean")] + "_std"]))
            assert np.all(np.abs(np.asarray(got[k]) - want[k]) <= TOL * scale), k
        else:
            assert _rel(got[k], want[k]) < TOL or np.array_equal(got[k], want[k]), k


def _same_files(got_path, want_path, latent_ulp=False):
    with h5py.File(got_path, "r") as g, h5py.File(want_path, "r") as w:
        (gd, gg), (wd, wg) = _walk(g), _walk(w)
    assert sorted(gd) == sorted(wd) and sorted(gg) == sorted(wg)
    for name in wg:
        _same_attrs(gg[name], wg[name])
    for name, (want, wattrs) in wd.items():
        got, gattrs = gd[name]
        assert got.dtype == want.dtype and got.shape == want.shape, name
        assert gattrs == wattrs, name
        leaf = name.rsplit("/", 1)[-1]
        if leaf in ("residual", "lowfreq"):
            assert _rel(got, want) < TOL, name
        elif leaf == "latent" and latent_ulp:
            a, b = got.astype(np.float32), want.astype(np.float32)
            step = np.spacing(np.maximum(np.abs(got), np.abs(want))).astype(np.float32)
            diff = np.abs(a - b)
            assert np.all((diff <= step) | (diff <= TOL * np.abs(b).max())), name
        else:
            np.testing.assert_array_equal(got, want, err_msg=name)


@pytest.fixture(scope="module")
def base_files(rasters, tmp_path_factory):
    """The base dataset built by both packages, then each rerun (a resume)."""
    root = tmp_path_factory.mktemp("base")
    got, want = str(root / "port.h5"), str(root / "jax.h5")
    kw = dict(_base_kwargs(rasters), cell_size_m=CELL_M, ocean_keep_pct=0.5, num_workers=3,
              seed=5)
    build_base_dataset.build_base_dataset(got, **kw, device="cpu")
    jax_base.build_base_dataset(want, **kw)
    return got, want, kw


def test_build_base_dataset_matches_jax(base_files):
    got, want, kw = base_files
    _same_files(got, want)
    with h5py.File(got, "r") as f:
        res = f["90"]
        assert {"residual_mean", "residual_std", "lowfreq_mean", "lowfreq_std"} <= set(res.attrs)
        pct = [res[c][s]["residual"].attrs["pct_land"] for c in res for s in res[c]]
        n_subchunks = len(pct)
    assert 0 < sum(p == 0 for p in pct) < n_subchunks  # ocean kept in part, land too
    # a rerun processes only the cells that left no chunk and keeps the stats
    with h5py.File(got, "r") as f:
        before = dict(f["90"].attrs)
    build_base_dataset.build_base_dataset(got, **kw, device="cpu")
    jax_base.build_base_dataset(want, **kw)
    _same_files(got, want)
    with h5py.File(got, "r") as f:
        assert dict(f["90"].attrs) == before


@pytest.fixture(scope="module")
def vae_dirs(tmp_path_factory):
    """A tiny VAE saved by the port, and the same weights saved by JAX."""
    root = tmp_path_factory.mktemp("vae")
    cfg = EDMAutoencoderConfig.from_dict(dict(
        image_size=32, in_channels=1, out_channels=1, model_channels=8,
        model_channel_mults=[1, 2], layers_per_block=1, latent_channels=4,
        attn_resolutions=[], midblock_attention=False))
    model = EDMAutoencoder(cfg, device="cpu", generator=torch.Generator().manual_seed(8))
    port_dir, jax_dir = str(root / "port_vae"), str(root / "jax_vae")
    torch_compat.save_model(model, port_dir)
    jax_compat.save_model(*jax_compat.load_model(port_dir), jax_dir)
    return port_dir, jax_dir


@pytest.fixture(scope="module")
def encoded_files(base_files, vae_dirs, tmp_path_factory):
    """The base files encoded: the port reads JAX's saved VAE, JAX the port's."""
    root = tmp_path_factory.mktemp("encoded")
    got, want = str(root / "port.h5"), str(root / "jax.h5")
    shutil.copy(base_files[1], got)
    shutil.copy(base_files[1], want)
    port_dir, jax_dir = vae_dirs
    result = CliRunner().invoke(port_main.cli, ["build-encoded-dataset", got, jax_dir,
                                                "--residual-std", "1.3", "--device", "cpu"])
    assert result.exit_code == 0, result.output
    jax_encoded.build_encoded_dataset(want, port_dir, residual_std=1.3)
    return got, want


def test_build_encoded_dataset_matches_jax(encoded_files, vae_dirs):
    got, want = encoded_files
    _same_files(got, want, latent_ulp=True)
    with h5py.File(got, "r") as f:
        res = f["90"]
        lat = [res[c][s]["latent"] for c in res for s in res[c]]
        assert lat and all(d.shape == (8, 8, 16, 16) and d.dtype == np.float16 for d in lat)
        assert len(res.attrs["latents_mean"]) == 4
        mean = np.array(res.attrs["latents_mean"])
    # a rerun encodes nothing and keeps the stats
    build_encoded_dataset.build_encoded_dataset(got, vae_dirs[1], residual_std=1.3,
                                                device="cpu")
    with h5py.File(got, "r") as f:
        np.testing.assert_array_equal(f["90"].attrs["latents_mean"], mean)


def test_encode_residual_is_the_d4_views_of_jax(vae_dirs):
    ae = torch_compat.load_model(vae_dirs[0], device="cpu")
    jae, params = jax_compat.load_model(vae_dirs[0])
    residual = np.random.default_rng(4).standard_normal((32, 32)).astype(np.float32)
    got = build_encoded_dataset.encode_residual(ae, residual, sigma_data=0.5,
                                                residual_mean=0.1, residual_std=1.2)
    stack = jax_encoded._d4_stack((residual - 0.1) / 1.2 * 0.5)
    np.testing.assert_array_equal(build_encoded_dataset._d4_stack(residual),
                                  jax_encoded._d4_stack(residual))
    means, logvars = jae.preencode(params, stack[..., None])
    want = np.moveaxis(np.concatenate([means, logvars], axis=-1), -1, 1)
    assert got.shape == (8, 8, 16, 16) and got.dtype == np.float32
    assert _rel(got, want) < TOL


def test_define_splits_match_jax(encoded_files, tmp_path):
    paths = {}
    for who, fn in (("port", define_splits.split_dataset), ("jax", jax_splits.split_dataset)):
        h5 = str(tmp_path / f"{who}.h5")
        shutil.copy(encoded_files[1], h5)
        fn(h5, val_pct=0.4, seed=3, splits_csv=str(tmp_path / f"{who}.csv"))
        paths[who] = h5
    with open(tmp_path / "port.csv") as a, open(tmp_path / "jax.csv") as b:
        rows = a.read()
        assert rows == b.read()
    assert {r[1] for r in csv.reader(rows.splitlines())} == {"train", "val"}
    _same_files(paths["port"], paths["jax"])
    # through the group, with the CSV kept: another seed changes nothing
    result = CliRunner().invoke(port_main.cli, ["define-splits", paths["port"], "--seed", "9",
                                                "--splits-csv", str(tmp_path / "port.csv")])
    assert result.exit_code == 0, result.output
    _same_files(paths["port"], paths["jax"])


def test_score_dataset_matches_jax(base_files, tmp_path):
    got, want = str(tmp_path / "port.h5"), str(tmp_path / "jax.h5")
    shutil.copy(base_files[1], got)
    shutil.copy(base_files[1], want)
    manual = tmp_path / "manual.csv"
    manual.write_text("90/0/chunk_0_0,4.5\n")
    assert beauty_score.main.main([got, "--manual-scores", str(manual), "--device", "cpu"],
                                  standalone_mode=False) > 0
    jax_beauty.score_dataset(want, manual_scores_csv=str(manual))
    with h5py.File(got, "r") as g, h5py.File(want, "r") as w:
        subs = [f"90/{c}/{s}" for c in w["90"] for s in w["90"][c]]
        scores = [(g[k].attrs["beauty_score"], w[k].attrs["beauty_score"]) for k in subs]
    assert all(abs(a - b) <= TOL * abs(b) for a, b in scores)
    assert dict(zip(subs, scores)).get("90/0/chunk_0_0", (4.5, 4.5)) == (4.5, 4.5)
    assert len({round(b, 6) for _, b in scores}) > 2  # not all clipped alike


def test_beauty_score_of_one_subchunk():
    rng = np.random.default_rng(12)  # a residual of broadband detail, as terrain's is
    residual = _field(rng, (64, 64), 2.0) + rng.standard_normal((64, 64)).astype(np.float32)
    for offset in (20.0, -20.0):  # land, and ocean (score 1)
        lowfreq = _field(rng, (16, 16), 5.0, offset)
        got = beauty_score.calculate_beauty_score(lowfreq, residual, device="cpu")
        want = jax_beauty.calculate_beauty_score(lowfreq, residual)
        assert abs(got - want) <= TOL * abs(want)
    assert got == 1.0
    _, powers = beauty_score.analyze_terrain_frequency(residual, bins=4)
    assert powers == jax_beauty.analyze_terrain_frequency(residual, bins=4)[1]


def test_build_raw_dataset_matches_jax(rasters, tmp_path):
    outs = {}
    for who, cmd in (("port", build_raw_dataset.main), ("jax", jax_raw.main)):
        outs[who] = str(tmp_path / f"{who}.h5")
        cmd.main(["--elevation-folder", str(rasters / "raw"), "--output-size", "24", "-o",
                  outs[who], "--limit", "3"], standalone_mode=False)
    with h5py.File(outs["port"], "r") as g, h5py.File(outs["jax"], "r") as w:
        assert sorted(g) == sorted(w) and len(w) == 3
        for k in w:
            np.testing.assert_array_equal(g[k][()], w[k][()])


@pytest.mark.parametrize("argv", [["h5", "{h5}"], ["h5", "{h5}", "--dataset", "lowfreq",
                                                   "--resolution", "90"],
                                  ["rasters", "{raw}"], ["rasters", "{raw}", "--signed-sqrt"]],
                         ids=["h5", "h5-lowfreq", "rasters", "rasters-signed-sqrt"])
def test_calculate_stats_prints_what_jax_prints(base_files, rasters, capsys, argv):
    argv = [a.format(h5=base_files[1], raw=rasters / "raw") for a in argv]
    calculate_stats.cli.main(argv, standalone_mode=False)
    got = capsys.readouterr().out
    jax_calc.cli.main(argv, standalone_mode=False)
    want = capsys.readouterr().out
    assert got == want and "mean=" in got


@pytest.mark.parametrize("argv", [["build-base-dataset", "out.h5", "--highres-folder", ".",
                                   "--lowres-file", "x.tif"],
                                  ["build-encoded-dataset", "in.h5", "."]],
                         ids=["base", "encoded"])
def test_builders_default_to_the_card(monkeypatch, tmp_path, argv):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.chdir(tmp_path)
    (tmp_path / "in.h5").write_bytes(b"")
    result = CliRunner().invoke(port_main.cli, argv)
    assert result.exit_code != 0 and "--device cpu" in result.output
    assert not os.path.exists(tmp_path / "out.h5")
