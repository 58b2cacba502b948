"""Coarse world-map dataset (counterpart of
``terrain_diffusion_tpu/training/datasets/coarse_dataset.py``): a
self-building HDF5 of latitude bands from ETOPO and WorldClim GeoTIFFs.

Build: read the rasters in [-60, 60] latitude, signed-sqrt elevation, split
into 10 latitude bands, equal-area rescale each band by 1 / cos(lat),
aggregate ``tile_px`` blocks (mean and p5), inpaint the climate's ocean NaNs
by a coarse-to-fine Laplace CG solve (``fill_oceans``), store per-band
6-channel arrays and global stats.  The build writes with ``h5py``.

Sampling: a random band (area-weighted), ``max_of_n`` roughness-biased crop
selection, D4 augmentation, a per-channel TrigFlow-noised conditioning
image with random per-channel t and the ``log(tan(t) / 8)`` scalar
conditioning inputs, all from ``self.rng`` (numpy).  NHWC items.
"""
from __future__ import annotations

import numpy as np

from terrain_diffusion_tpu_torch.common.geotiff import read_geotiff


def fill_oceans(a: np.ndarray, *, tol: float = 1e-6, maxiter: int | None = None,
                multires_factor: int = 8) -> np.ndarray:
    """Fill NaN (ocean) pixels by solving the Laplace equation with Dirichlet
    coast values and Neumann outer edges, with a coarse-to-fine init."""
    import scipy.sparse as sp
    from scipy.sparse.linalg import cg

    if a.ndim != 2:
        raise ValueError("a must be 2D")
    arr = a.astype(np.float64, copy=True)
    ocean = np.isnan(arr)
    if not ocean.any():
        return arr
    if ocean.all():
        return np.zeros_like(arr)

    def solve(arr_in, ocean_mask, x0=None, tol=tol):
        H, W = arr_in.shape
        idx_map = -np.ones((H, W), np.int64)
        oc = np.flatnonzero(ocean_mask.ravel())
        idx_map.ravel()[oc] = np.arange(oc.size)
        n = oc.size
        ii, jj = np.divmod(oc, W)
        rows, cols, vals = [], [], []
        b = np.zeros(n)
        diag = np.zeros(n)
        for di, dj in ((-1, 0), (1, 0), (0, -1), (0, 1)):
            ni, nj = ii + di, jj + dj
            inb = (ni >= 0) & (ni < H) & (nj >= 0) & (nj < W)
            diag += inb
            k = np.flatnonzero(inb)
            nlin = ni[k] * W + nj[k]
            is_oc = ocean_mask.ravel()[nlin]
            # ocean neighbors: off-diagonal -1
            ko = k[is_oc]
            rows.append(ko)
            cols.append(idx_map.ravel()[ni[ko] * W + nj[ko]])
            vals.append(np.full(ko.size, -1.0))
            # land neighbors: contribute to b
            kl = k[~is_oc]
            np.add.at(b, kl, arr_in.ravel()[ni[kl] * W + nj[kl]])
        rows.append(np.arange(n))
        cols.append(np.arange(n))
        vals.append(diag)
        A = sp.csr_matrix((np.concatenate(vals),
                           (np.concatenate(rows), np.concatenate(cols))),
                          shape=(n, n))
        mi = maxiter or int(10 * np.sqrt(n)) + 100
        x, _ = cg(A, b, x0=x0, rtol=tol, maxiter=mi)
        out = arr_in.copy()
        out[ocean_mask] = x
        return out

    # coarse init
    H, W = arr.shape
    f = multires_factor
    if min(H, W) >= 2 * f:
        Hc, Wc = H // f, W // f
        blocks = arr[: Hc * f, : Wc * f].reshape(Hc, f, Wc, f)
        with np.errstate(invalid="ignore"):
            coarse = np.nanmean(np.nanmean(blocks, axis=3), axis=1)
        oc_c = np.isnan(coarse)
        if oc_c.any() and not oc_c.all():
            # solve() reads land values from arr_in for the Dirichlet b and
            # copies them through; ocean NaNs are never read
            coarse_f = solve(coarse, oc_c, tol=1e-2)
        else:
            coarse_f = np.nan_to_num(coarse, nan=float(np.nanmean(arr)))
        # bilinear upsample for x0
        up = np.kron(coarse_f, np.ones((f, f)))[:H, :W]
        if up.shape != arr.shape:
            pad = ((0, H - up.shape[0]), (0, W - up.shape[1]))
            up = np.pad(up, pad, mode="edge")
        x0 = up[ocean]
    else:
        x0 = None
    return solve(arr, ocean, x0=x0)


def _area_resize(band: np.ndarray, new_w: int) -> np.ndarray:
    """Area (box) downsample along width, NaN-aware."""
    h, w = band.shape
    xs = np.linspace(0, w, new_w + 1)
    out = np.empty((h, new_w), np.float64)
    for k in range(new_w):
        a, b = int(xs[k]), max(int(xs[k + 1]), int(xs[k]) + 1)
        with np.errstate(invalid="ignore"):
            out[:, k] = np.nanmean(band[:, a:b], axis=1)
    return out


class CoarseDataset:
    def __init__(self, h5_file, etopo_file=None, mean_temp_file=None,
                 std_temp_file=None, mean_precip_file=None,
                 std_precip_file=None, crop_size=16, tile_px=26,
                 sigma_data=0.5, max_of_n=1):
        import os

        import h5py

        self.h5_file = h5_file
        self.crop_size = crop_size
        self.sigma_data = sigma_data
        self.max_of_n = max_of_n
        self.rng = np.random.default_rng(0)
        if not os.path.exists(h5_file):
            self._build(h5_file, etopo_file, mean_temp_file, std_temp_file,
                        mean_precip_file, std_precip_file, tile_px)
        with h5py.File(h5_file, "r") as f:
            self.band_weights = np.asarray(f.attrs["band_weights"], np.float64)
            self.means = np.asarray(f.attrs["means"], np.float64)
            self.stds = np.asarray(f.attrs["stds"], np.float64)
            self._bands = [np.asarray(f[f"gan_band_{i}"], np.float32)
                           for i in range(len(self.band_weights))]

    # ------------------------------------------------------------------
    def _build(self, h5_file, etopo_file, mean_temp_file, std_temp_file,
               mean_precip_file, std_precip_file, tile_px):
        import h5py

        print("Building coarse HDF5...")
        elev, transform, _ = read_geotiff(etopo_file)
        elev = elev.astype(np.float64)
        height = elev.shape[0]
        top = transform.f if transform else 90.0
        lat_res = -transform.e if transform else 180.0 / height
        start_row = max(0, int((top - 60) / lat_res))
        end_row = min(height, int((top + 60) / lat_res))
        elev = np.sign(elev) * np.sqrt(np.abs(elev))
        elev = elev[start_row:end_row]

        row_idx = np.linspace(0, elev.shape[0], 10, dtype=int)
        clim_files = [mean_temp_file, std_temp_file, mean_precip_file, std_precip_file]
        clim = []
        for fpath in clim_files:
            c, _, _ = read_geotiff(fpath)
            c = c.astype(np.float64)
            c[np.abs(c) > 1e6] = np.nan
            c[c < -30000] = np.nan
            clim.append(c[start_row:end_row])

        with h5py.File(h5_file, "w") as f:
            widths = []
            for i, (r0, r1) in enumerate(zip(row_idx[:-1], row_idx[1:])):
                mid_lat = top - (r0 + r1 + start_row * 2) / 2 * lat_res
                lat_scale = 1 / np.cos(np.deg2rad(mid_lat))
                band = elev[r0:r1]
                new_w = round(band.shape[1] / lat_scale)
                scaled = _area_resize(band, new_w)
                hh = scaled.shape[0] // tile_px * tile_px
                ww = scaled.shape[1] // tile_px * tile_px
                tiles = scaled[:hh, :ww].reshape(hh // tile_px, tile_px,
                                                 ww // tile_px, tile_px)
                means = tiles.mean(axis=(1, 3))
                p5 = np.quantile(tiles, 0.05, axis=(1, 3))
                out = np.zeros((6, means.shape[0], means.shape[1]))
                out[0] = means
                out[1] = means - p5
                for ci, cdata in enumerate(clim):
                    cband = _area_resize(cdata[r0:r1], new_w)
                    ctiles = cband[:hh, :ww].reshape(hh // tile_px, tile_px,
                                                     ww // tile_px, tile_px)
                    with np.errstate(invalid="ignore"):
                        cmeans = np.nanmean(np.nanmean(ctiles, axis=3), axis=1)
                    out[2 + ci] = fill_oceans(cmeans, tol=1e-2)
                f.create_dataset(f"gan_band_{i}", data=out)
                widths.append(out.shape[1] * out.shape[2])
            weights = np.asarray(widths, np.float64)
            f.attrs["band_weights"] = weights / weights.sum()
            all_vals = np.concatenate(
                [np.asarray(f[f"gan_band_{i}"]).reshape(6, -1)
                 for i in range(9)], axis=1)
            f.attrs["means"] = np.nanmean(all_vals, axis=1)
            f.attrs["stds"] = np.nanstd(all_vals, axis=1)

    # ------------------------------------------------------------------
    def __len__(self):
        return 100000

    def set_seed(self, seed):
        self.rng = np.random.default_rng(int(seed) % 2**63)

    def __getitem__(self, idx):
        best, best_score, last = None, -1.0, None
        for _ in range(self.max_of_n):
            band_idx = int(self.rng.choice(len(self.band_weights),
                                           p=self.band_weights))
            data = self._bands[band_idx]
            data = ((data - self.means[:, None, None]) /
                    self.stds[:, None, None]).astype(np.float32)
            cs = self.crop_size
            i = int(self.rng.integers(0, data.shape[1] - cs + 1))
            j = int(self.rng.integers(0, data.shape[2] - cs + 1))
            crop = data[:, i:i + cs, j:j + cs]
            elev_sqrt = crop[0] * self.stds[0] + self.means[0]
            elev = np.sign(elev_sqrt) * np.square(elev_sqrt)
            elev = np.maximum(elev, 0)
            # roughness score: p90 of squared difference vs 3x3 box blur
            p = np.pad(elev, 1, mode="edge")
            blur = sum(p[a:a + cs, b:b + cs] for a in range(3) for b in range(3)) / 9
            score = float(np.quantile((elev - blur) ** 2, 0.9))
            if score > best_score:
                best_score, best = score, crop
            last = crop
        data = best if self.rng.random() > 0.25 else last
        if self.rng.random() > 0.5:
            data = data[:, ::-1, :]
        k = int(self.rng.integers(0, 4))
        if k:
            data = np.rot90(data, k=k, axes=(-2, -1))
        data = np.ascontiguousarray(data) * self.sigma_data

        t = np.arctan(np.exp(10 * self.rng.random(5) - 5)).reshape(-1, 1, 1)
        cond = data[[0, 2, 3, 4, 5]] / self.sigma_data
        cond = cond * np.cos(t) + self.rng.standard_normal(cond.shape).astype(np.float32) * np.sin(t)
        return {
            "image": np.moveaxis(data, 0, -1).astype(np.float32),
            "cond_img": np.moveaxis(cond, 0, -1).astype(np.float32),
            "cond_inputs": [np.float32(np.log(np.tan(s) / 8)) for s in t.ravel()],
        }
