"""First-party coordinate reference system transforms (no GDAL/pyproj).

Counterpart of ``terrain_diffusion_tpu.common.crs``: the same numpy code, kept as
the port's own copy.

Supports the CRS families that elevation datasets actually ship in
(reference counterpart: rasterio.warp usage in
`data/preprocessing/elevation_dataset.py:34-161`):

- ``EPSG:4326``          geographic WGS84 (identity)
- ``EPSG:3857``          Web / spherical Mercator
- ``EPSG:326xx/327xx``   WGS84 UTM north/south zones (Transverse Mercator,
  Krüger n-series to n^4 — sub-millimeter vs the exact projection)
- ``EPSG:3031/3413``     Antarctic / NSIDC Arctic polar stereographic
  (the CRSes REMA / ArcticDEM tiles ship in)

Anything else raises ``UnsupportedCRSError`` with a clear message; callers
should reproject such rasters externally to EPSG:4326 first.

All transforms are vectorized over numpy arrays:
``to_wgs84(x, y) -> (lon, lat)`` and ``from_wgs84(lon, lat) -> (x, y)``.
"""
from __future__ import annotations

import numpy as np

# WGS84 ellipsoid
_A = 6378137.0
_F = 1.0 / 298.257223563
_E2 = _F * (2.0 - _F)
_E = np.sqrt(_E2)


class UnsupportedCRSError(ValueError):
    pass


def _parse_epsg(crs) -> int:
    if isinstance(crs, int):
        return crs
    s = str(crs).strip().upper()
    if s.startswith("EPSG:"):
        return int(s[5:])
    if s.isdigit():
        return int(s)
    raise UnsupportedCRSError(f"cannot parse CRS {crs!r}; use 'EPSG:<code>'")


# ---------------------------------------------------------------------------
# Transverse Mercator (Krüger series; forward + inverse)
# ---------------------------------------------------------------------------

_N = _F / (2.0 - _F)
_A_CAP = _A / (1 + _N) * (1 + _N ** 2 / 4 + _N ** 4 / 64)
_ALPHA = (
    _N / 2 - 2 * _N ** 2 / 3 + 5 * _N ** 3 / 16 + 41 * _N ** 4 / 180,
    13 * _N ** 2 / 48 - 3 * _N ** 3 / 5 + 557 * _N ** 4 / 1440,
    61 * _N ** 3 / 240 - 103 * _N ** 4 / 140,
    49561 * _N ** 4 / 161280,
)
_BETA = (
    _N / 2 - 2 * _N ** 2 / 3 + 37 * _N ** 3 / 96 - _N ** 4 / 360,
    _N ** 2 / 48 + _N ** 3 / 15 - 437 * _N ** 4 / 1440,
    17 * _N ** 3 / 480 - 37 * _N ** 4 / 840,
    4397 * _N ** 4 / 161280,
)
_DELTA = (
    2 * _N - 2 * _N ** 2 / 3 - 2 * _N ** 3 + 116 * _N ** 4 / 45,
    7 * _N ** 2 / 3 - 8 * _N ** 3 / 5 - 227 * _N ** 4 / 45,
    56 * _N ** 3 / 15 - 136 * _N ** 4 / 35,
    4279 * _N ** 4 / 315,
)
_TM_K0 = 0.9996
_TM_FE = 500000.0


def _tm_forward(lon, lat, lon0_deg, false_northing):
    lam = np.radians(np.asarray(lon, np.float64) - lon0_deg)
    phi = np.radians(np.asarray(lat, np.float64))
    s2n = 2 * np.sqrt(_N) / (1 + _N)
    t = np.sinh(np.arctanh(np.sin(phi)) - s2n * np.arctanh(s2n * np.sin(phi)))
    xi_p = np.arctan2(t, np.cos(lam))
    eta_p = np.arctanh(np.sin(lam) / np.sqrt(1 + t ** 2))
    xi = xi_p.copy()
    eta = eta_p.copy()
    for j, a in enumerate(_ALPHA, start=1):
        xi = xi + a * np.sin(2 * j * xi_p) * np.cosh(2 * j * eta_p)
        eta = eta + a * np.cos(2 * j * xi_p) * np.sinh(2 * j * eta_p)
    return (_TM_FE + _TM_K0 * _A_CAP * eta,
            false_northing + _TM_K0 * _A_CAP * xi)


def _tm_inverse(x, y, lon0_deg, false_northing):
    xi = (np.asarray(y, np.float64) - false_northing) / (_TM_K0 * _A_CAP)
    eta = (np.asarray(x, np.float64) - _TM_FE) / (_TM_K0 * _A_CAP)
    xi_p = xi.copy()
    eta_p = eta.copy()
    for j, b in enumerate(_BETA, start=1):
        xi_p = xi_p - b * np.sin(2 * j * xi) * np.cosh(2 * j * eta)
        eta_p = eta_p - b * np.cos(2 * j * xi) * np.sinh(2 * j * eta)
    chi = np.arcsin(np.clip(np.sin(xi_p) / np.cosh(eta_p), -1.0, 1.0))
    phi = chi.copy()
    for j, d in enumerate(_DELTA, start=1):
        phi = phi + d * np.sin(2 * j * chi)
    lam = np.arctan2(np.sinh(eta_p), np.cos(xi_p))
    return np.degrees(lam) + lon0_deg, np.degrees(phi)


# ---------------------------------------------------------------------------
# Polar stereographic (Snyder 1987, eqs. 21-33..21-41 variant B)
# ---------------------------------------------------------------------------

def _ps_t(phi):
    return (np.tan(np.pi / 4 - phi / 2)
            / ((1 - _E * np.sin(phi)) / (1 + _E * np.sin(phi))) ** (_E / 2))


def _ps_forward(lon, lat, lat_ts_deg, lon0_deg, south):
    lon = np.asarray(lon, np.float64)
    lat = np.asarray(lat, np.float64)
    sgn = -1.0 if south else 1.0
    phi = np.radians(sgn * lat)
    lam = np.radians(sgn * (lon - lon0_deg))
    phi_ts = np.radians(abs(lat_ts_deg))
    m_ts = np.cos(phi_ts) / np.sqrt(1 - _E2 * np.sin(phi_ts) ** 2)
    rho = _A * m_ts * _ps_t(phi) / _ps_t(phi_ts)
    x = rho * np.sin(lam)
    y = -rho * np.cos(lam)
    return sgn * x, sgn * y


def _ps_inverse(x, y, lat_ts_deg, lon0_deg, south):
    sgn = -1.0 if south else 1.0
    x = sgn * np.asarray(x, np.float64)
    y = sgn * np.asarray(y, np.float64)
    phi_ts = np.radians(abs(lat_ts_deg))
    m_ts = np.cos(phi_ts) / np.sqrt(1 - _E2 * np.sin(phi_ts) ** 2)
    rho = np.hypot(x, y)
    t = rho * _ps_t(phi_ts) / (_A * m_ts)
    # fixed-point iteration for phi (converges quadratically, ~5 iters)
    phi = np.pi / 2 - 2 * np.arctan(t)
    for _ in range(8):
        phi = (np.pi / 2 - 2 * np.arctan(
            t * ((1 - _E * np.sin(phi)) / (1 + _E * np.sin(phi))) ** (_E / 2)))
    lam = np.arctan2(x, -y)
    lon = sgn * np.degrees(lam) + lon0_deg
    lon = (lon + 180.0) % 360.0 - 180.0
    return lon, sgn * np.degrees(phi)


# ---------------------------------------------------------------------------
# Public CRS object
# ---------------------------------------------------------------------------

class CRS:
    """Bidirectional transform between an EPSG CRS and WGS84 lon/lat."""

    def __init__(self, crs):
        self.epsg = _parse_epsg(crs)
        code = self.epsg
        if code == 4326:
            self._fwd = self._inv = None
        elif code == 3857:
            r = _A

            def fwd(lon, lat):
                lon = np.asarray(lon, np.float64)
                lat = np.clip(np.asarray(lat, np.float64), -89.9999, 89.9999)
                return (r * np.radians(lon),
                        r * np.log(np.tan(np.pi / 4 + np.radians(lat) / 2)))

            def inv(x, y):
                return (np.degrees(np.asarray(x, np.float64) / r),
                        np.degrees(2 * np.arctan(np.exp(np.asarray(y, np.float64) / r))
                                   - np.pi / 2))

            self._fwd, self._inv = fwd, inv
        elif 32601 <= code <= 32660 or 32701 <= code <= 32760:
            zone = code % 100
            south = code >= 32701
            lon0 = zone * 6 - 183
            fn = 10000000.0 if south else 0.0
            self._fwd = lambda lon, lat: _tm_forward(lon, lat, lon0, fn)
            self._inv = lambda x, y: _tm_inverse(x, y, lon0, fn)
        elif code in (3031, 3413):
            lat_ts, lon0, south = {
                3031: (-71.0, 0.0, True),    # Antarctic polar stereographic
                3413: (70.0, -45.0, False),  # NSIDC Sea Ice Polar Stereo N
            }[code]
            self._fwd = lambda lon, lat: _ps_forward(lon, lat, lat_ts, lon0, south)
            self._inv = lambda x, y: _ps_inverse(x, y, lat_ts, lon0, south)
        else:
            raise UnsupportedCRSError(
                f"EPSG:{code} is not supported by the first-party CRS engine "
                "(supported: 4326, 3857, UTM 326xx/327xx, 3031, 3413). "
                "Reproject the raster to EPSG:4326 externally first.")

    @property
    def is_geographic(self) -> bool:
        return self.epsg == 4326

    def from_wgs84(self, lon, lat):
        """(lon, lat) degrees -> projected (x, y)."""
        if self._fwd is None:
            return np.asarray(lon, np.float64), np.asarray(lat, np.float64)
        return self._fwd(lon, lat)

    def to_wgs84(self, x, y):
        """projected (x, y) -> (lon, lat) degrees."""
        if self._inv is None:
            return np.asarray(x, np.float64), np.asarray(y, np.float64)
        return self._inv(x, y)

    def transform_bounds(self, west, south, east, north, densify: int = 21):
        """WGS84 bounds -> tight projected bounding box (edge-densified,
        rasterio.warp.transform_bounds semantics)."""
        t = np.linspace(0.0, 1.0, densify)
        xs = np.concatenate([west + (east - west) * t,
                             np.full(densify, east),
                             east + (west - east) * t,
                             np.full(densify, west)])
        ys = np.concatenate([np.full(densify, south),
                             south + (north - south) * t,
                             np.full(densify, north),
                             north + (south - north) * t])
        px, py = self.from_wgs84(xs, ys)
        return float(px.min()), float(py.min()), float(px.max()), float(py.max())
