"""The port's DEM acquisition tools on the CPU
(terrain_diffusion_tpu_torch.data.downloading), offline:

- ``extract_grid_data`` on a seeded synthetic global GeoTIFF (with nodata)
  writes the same files as JAX's, with bit-equal arrays, transforms and
  nodata, with and without a valid-pixel floor; so does ``main``;
- ``download_cell`` with a fake ``ee`` module in ``sys.modules`` whose
  download URL is a local ``file://`` path: success through a temporary
  file renamed into place, a retry after a failed attempt (``time.sleep``
  patched), the clean-up of a partial file when every attempt fails, and
  an existing file left as it is; ``download_dem`` drives it on its
  thread pool;
- without ``ee`` the error names ``earthengine-api``; the command group
  registers neither tool, as JAX's does not.
"""
import glob
import os
import sys
import types

import numpy as np
import pytest

from terrain_diffusion_tpu.common.geotiff import read_geotiff as jax_read_geotiff
from terrain_diffusion_tpu.data.downloading import extract as jax_extract

from terrain_diffusion_tpu_torch.common.geotiff import Affine, read_geotiff, write_geotiff
from terrain_diffusion_tpu_torch.data.downloading import downloader, extract
from terrain_diffusion_tpu_torch.data.world_grid import create_equal_area_grid

CELL_M = 2.0e6


@pytest.fixture(scope="module")
def raster(tmp_path_factory):
    """A 0.5-degree global raster over [-180, 180] x [-70, 70], seeded, with
    nodata over a band of rows."""
    rng = np.random.default_rng(3)
    arr = (rng.standard_normal((280, 720)) * 500).astype(np.float32)
    arr[100:140, 200:500] = -9999.0
    path = str(tmp_path_factory.mktemp("src") / "global.tif")
    write_geotiff(path, arr, Affine(0.5, 0.0, -180.0, 0.0, -0.5, 70.0), nodata=-9999.0)
    return path


def _cells(folder):
    out = {}
    for f in sorted(glob.glob(os.path.join(folder, "*.tif"))):
        arr, transform, nodata = read_geotiff(f)
        out[os.path.basename(f)] = (arr, transform, nodata)
    return out


@pytest.mark.parametrize("min_valid_pct", [0.0, 0.9])
def test_extract_equals_jax(raster, tmp_path, min_valid_pct):
    cells = create_equal_area_grid((CELL_M, CELL_M))
    extract.extract_grid_data(raster, cells, str(tmp_path / "port"), "dem_", min_valid_pct)
    jax_extract.extract_grid_data(raster, cells, str(tmp_path / "jax"), "dem_", min_valid_pct)
    port, ref = _cells(str(tmp_path / "port")), _cells(str(tmp_path / "jax"))
    assert port.keys() == ref.keys() and len(port) > 10
    for name, (arr, transform, nodata) in port.items():
        jarr, jtransform, jnodata = jax_read_geotiff(str(tmp_path / "jax" / name))
        np.testing.assert_array_equal(arr, jarr)
        assert arr.dtype == jarr.dtype == np.float32
        assert (transform.a, transform.c, transform.e, transform.f) == (
            jtransform.a, jtransform.c, jtransform.e, jtransform.f)
        assert nodata == jnodata == -9999.0
    if min_valid_pct:
        assert len(port) < len(create_equal_area_grid((CELL_M, CELL_M)))


def test_extract_main(raster, tmp_path):
    from click.testing import CliRunner

    res = CliRunner().invoke(extract.main, [raster, str(tmp_path / "out"),
                                            "--cell-size-m", str(CELL_M), "--prefix", "x_"])
    assert res.exit_code == 0, res.output
    names = sorted(os.listdir(tmp_path / "out"))
    assert names and all(n.startswith("x_") and n.endswith(".tif") for n in names)


class FakeEE(types.ModuleType):
    """The part of ``ee`` the downloader calls; ``getDownloadURL`` gives the
    next of ``urls`` (a ``file://`` URL, or an exception to raise)."""

    def __init__(self, urls):
        super().__init__("ee")
        self.urls, self.calls, self.initialized = list(urls), [], None
        fake = self

        class Geometry:
            @staticmethod
            def Rectangle(coords):
                return ("rect", tuple(coords))

        class Image:
            def __init__(self, asset):
                self.asset = asset

            def select(self, band):
                self.band = band
                return self

            def getDownloadURL(self, params):
                fake.calls.append((self.asset, self.band, params["scale"], params["format"]))
                url = fake.urls.pop(0) if len(fake.urls) > 1 else fake.urls[0]
                if isinstance(url, Exception):
                    raise url
                return url

        self.Geometry, self.Image = Geometry, Image

    def Initialize(self, opt_url=None):
        self.initialized = opt_url


@pytest.fixture
def no_sleep(monkeypatch):
    slept = []
    monkeypatch.setattr(downloader.time, "sleep", slept.append)
    return slept


def test_download_cell_success_and_existing_file(raster, tmp_path, no_sleep):
    ee = FakeEE(["file://" + raster])
    out = str(tmp_path)
    assert downloader.download_cell(ee, "merit", "7", (0, 0, 1, 1), out, 90)
    assert os.listdir(out) == ["dem_7.tif"] and not no_sleep
    with open(raster, "rb") as a, open(tmp_path / "dem_7.tif", "rb") as b:
        assert a.read() == b.read()
    assert ee.calls == [("MERIT/DEM/v1_0_3", "dem", 90, "GEO_TIFF")]
    assert downloader.download_cell(ee, "merit", "7", (0, 0, 1, 1), out, 90)
    assert len(ee.calls) == 1  # the existing file is not fetched again
    assert downloader.download_cell(ee, "copernicus", "7", (0, 0, 1, 1), out, 30)
    assert sorted(os.listdir(out)) == ["copernicus_7.tif", "dem_7.tif"]


def test_download_cell_retries(raster, tmp_path, no_sleep):
    ee = FakeEE([RuntimeError("quota"), "file://" + raster])
    assert downloader.download_cell(ee, "merit", "3", (0, 0, 1, 1), str(tmp_path), 90)
    assert no_sleep == [2.0] and os.listdir(tmp_path) == ["dem_3.tif"]


def test_download_cell_removes_a_partial_file(tmp_path, no_sleep):
    ee = FakeEE(["file://" + str(tmp_path / "missing.tif")])
    assert not downloader.download_cell(ee, "merit", "4", (0, 0, 1, 1), str(tmp_path), 90,
                                        retries=3)
    assert no_sleep == [2.0, 4.0, 6.0] and os.listdir(tmp_path) == []


def test_download_dem_on_its_thread_pool(raster, tmp_path, monkeypatch, no_sleep):
    ee = FakeEE(["file://" + raster])
    monkeypatch.setitem(sys.modules, "ee", ee)
    downloader.download_dem(str(tmp_path / "dem"), "merit", CELL_M, num_workers=2, limit=3)
    assert ee.initialized == "https://earthengine-highvolume.googleapis.com"
    assert sorted(os.listdir(tmp_path / "dem")) == ["dem_0.tif", "dem_1.tif", "dem_2.tif"]
    assert downloader._land_fraction((0, 0, 1, 1)) == 1.0  # no global_land_mask here


def test_require_ee_names_the_package(monkeypatch):
    monkeypatch.setitem(sys.modules, "ee", None)
    with pytest.raises(ImportError, match="earthengine-api"):
        downloader._require_ee()
    from terrain_diffusion_tpu_torch.__main__ import cli

    assert not {"download", "download-dem", "extract"} & set(cli.list_commands(None))
