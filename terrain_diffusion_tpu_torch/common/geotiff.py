"""Minimal first-party GeoTIFF IO (PIL-based, no GDAL/rasterio).

Counterpart of ``terrain_diffusion_tpu.common.geotiff``: the same code, kept as
the port's own copy; it reads and writes through PIL, imported where it is
used.

Supports the subset the framework needs (single-band float32/int16 rasters
with an affine geotransform, EPSG:4326 geographic CRS, nodata, LZW
compression) — the formats produced/consumed by ``azgaar-to-tiff`` and
``tiff-export`` (reference `inference/utils/azgaar_to_tiff.py`,
`inference/tiff_export.py`).

GeoTIFF tags written: ModelPixelScale (33550), ModelTiepoint (33922),
GeoKeyDirectory (34735, minimal geographic/EPSG key set), GDAL_NODATA
(42113), SampleFormat (339).
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class Affine:
    """Row-major affine geotransform: x = a*col + b*row + c; y = d*col + e*row + f."""
    a: float
    b: float
    c: float
    d: float
    e: float
    f: float

    @classmethod
    def from_bounds(cls, west, south, east, north, width, height) -> "Affine":
        return cls((east - west) / width, 0.0, west,
                   0.0, (south - north) / height, north)

    def scaled_pixels(self, factor: int) -> "Affine":
        """Transform for a raster with `factor`x more pixels per axis."""
        return Affine(self.a / factor, self.b, self.c,
                      self.d, self.e / factor, self.f)


_TAG_MODEL_PIXEL_SCALE = 33550
_TAG_MODEL_TIEPOINT = 33922
_TAG_GEO_KEY_DIRECTORY = 34735
_TAG_GDAL_NODATA = 42113
_TAG_SAMPLE_FORMAT = 339

# minimal geographic WGS84 key directory
_GEOKEYS_EPSG4326 = (1, 1, 0, 3,
                     1024, 0, 1, 2,      # GTModelType = geographic
                     1025, 0, 1, 1,      # RasterPixelIsArea
                     2048, 0, 1, 4326)   # GeographicType = WGS84


def _geokeys_projected(epsg: int):
    return (1, 1, 0, 3,
            1024, 0, 1, 1,          # GTModelType = projected
            1025, 0, 1, 1,          # RasterPixelIsArea
            3072, 0, 1, int(epsg))  # ProjectedCSType


def _crs_from_geokeys(keys):
    """'EPSG:<code>' from a GeoKeyDirectory tuple, or None."""
    if not keys or len(keys) < 4:
        return None
    keys = tuple(int(k) for k in keys)
    entries = {}
    for i in range(4, len(keys) - 3, 4):
        key_id, location, count, value = keys[i:i + 4]
        if location == 0 and count == 1:
            entries[key_id] = value
    if 3072 in entries and entries[3072] not in (0, 32767):
        return f"EPSG:{entries[3072]}"
    if 2048 in entries and entries[2048] not in (0, 32767):
        return f"EPSG:{entries[2048]}"
    return None


def write_geotiff(path, arr: np.ndarray, transform: Affine | None = None,
                  crs: str = "EPSG:4326", nodata=None, compress: str | None = "lzw"):
    from PIL import Image, TiffImagePlugin

    arr = np.asarray(arr)
    if arr.ndim != 2:
        raise ValueError("write_geotiff supports single-band 2-D arrays")

    if arr.dtype == np.float32 or arr.dtype == np.float64:
        img = Image.fromarray(arr.astype(np.float32), mode="F")
        sample_format = 3
    elif arr.dtype == np.int16:
        img = Image.fromarray(arr.view(np.uint16) if arr.dtype == np.int16 else arr,
                              mode="I;16")
        sample_format = 2
    elif arr.dtype in (np.uint16,):
        img = Image.fromarray(arr, mode="I;16")
        sample_format = 1
    elif arr.dtype in (np.uint8, np.int32):
        img = Image.fromarray(arr.astype(np.int32), mode="I")
        sample_format = 2 if arr.dtype == np.int32 else 1
    else:
        raise ValueError(f"unsupported dtype {arr.dtype}")

    info = TiffImagePlugin.ImageFileDirectory_v2()
    info[_TAG_SAMPLE_FORMAT] = sample_format
    if transform is not None:
        info[_TAG_MODEL_PIXEL_SCALE] = (float(transform.a), float(-transform.e), 0.0)
        info[_TAG_MODEL_TIEPOINT] = (0.0, 0.0, 0.0,
                                     float(transform.c), float(transform.f), 0.0)
    if crs in ("EPSG:4326", 4326):
        info[_TAG_GEO_KEY_DIRECTORY] = _GEOKEYS_EPSG4326
    elif crs is not None:
        code = int(str(crs).upper().replace("EPSG:", ""))
        info[_TAG_GEO_KEY_DIRECTORY] = _geokeys_projected(code)
    if nodata is not None:
        info[_TAG_GDAL_NODATA] = str(nodata)

    kwargs = {}
    if compress == "lzw":
        kwargs["compression"] = "tiff_lzw"
    img.save(str(path), format="TIFF", tiffinfo=info, **kwargs)


def read_geotiff_info(path):
    """Returns (array, transform | None, nodata | None, crs | None).

    ``crs`` is an 'EPSG:<code>' string parsed from the GeoKeyDirectory
    (ProjectedCSType key 3072 or GeographicType key 2048), or None when the
    file carries no CRS keys.
    """
    from PIL import Image

    arr, transform, nodata = read_geotiff(path)
    with Image.open(str(path)) as img:
        crs = _crs_from_geokeys(img.tag_v2.get(_TAG_GEO_KEY_DIRECTORY))
    return arr, transform, nodata, crs


def read_geotiff(path):
    """Returns (array, transform | None, nodata | None)."""
    from PIL import Image

    with Image.open(str(path)) as img:
        tags = img.tag_v2
        arr = np.asarray(img)
        sample_format = tags.get(_TAG_SAMPLE_FORMAT)
        if isinstance(sample_format, (tuple, list)):
            sample_format = sample_format[0]
        bits = tags.get(258)  # BitsPerSample
        if isinstance(bits, (tuple, list)):
            bits = bits[0]
        if sample_format == 2 and arr.dtype == np.uint16:
            arr = arr.view(np.int16)
        elif sample_format == 2 and arr.dtype == np.int32 and bits == 16:
            # PIL decodes signed 16-bit TIFF to int32; narrow back.  Gate
            # on the declared BitsPerSample — a value-range heuristic would
            # silently narrow genuine int32 rasters whose values happen to
            # fit, breaking write/read dtype round-trips
            arr = arr.astype(np.int16)
        transform = None
        if _TAG_MODEL_PIXEL_SCALE in tags and _TAG_MODEL_TIEPOINT in tags:
            sx, sy = tags[_TAG_MODEL_PIXEL_SCALE][:2]
            tie = tags[_TAG_MODEL_TIEPOINT]
            ox, oy = tie[3], tie[4]
            transform = Affine(float(sx), 0.0, float(ox), 0.0, -float(sy), float(oy))
        nodata = tags.get(_TAG_GDAL_NODATA)
        if nodata is not None:
            try:
                nodata = float(nodata)
            except (TypeError, ValueError):
                nodata = None
        return arr.copy(), transform, nodata


def rasterize_polygons(shapes, out_shape, fill=0.0, dtype=np.float32) -> np.ndarray:
    """Rasterize (polygon_ring, value) pairs into an array.

    ``shapes`` yields ``([(x, y), ...], value)``; later polygons overwrite
    earlier ones (same convention as rasterio.features.rasterize with
    all_touched=False).  Implemented via PIL polygon scan fill on a 32-bit
    index image.
    """
    from PIL import Image, ImageDraw

    shapes = list(shapes)
    idx_img = Image.new("I", (out_shape[1], out_shape[0]), 0)
    draw = ImageDraw.Draw(idx_img)
    values = [fill]
    for ring, value in shapes:
        # ALWAYS extend the LUT so the fill index stays in sync even when a
        # degenerate ring draws nothing (a skipped append shifted every
        # later polygon's value and could index past the LUT)
        values.append(value)
        if len(ring) < 3:
            continue
        draw.polygon([(float(x), float(y)) for x, y in ring],
                     fill=len(values) - 1)
    idx = np.asarray(idx_img)
    lut = np.asarray(values, dtype=np.float64)
    return lut[idx].astype(dtype)
