"""Climate -> Koppen biome training set for the perceptron (counterpart of
``terrain_diffusion_tpu/training/datasets/biome_dataset.py``).

Reads WorldClim bio rasters and a Koppen-Geiger class raster with the
port's GeoTIFF reader, samples ``length`` (climate 4-vector, class) pairs
within a latitude band, with optional input dropout.
"""
from __future__ import annotations

import numpy as np

from terrain_diffusion_tpu_torch.common.geotiff import read_geotiff


def _read_band(path, start_row, end_row):
    arr, _, nodata = read_geotiff(path)
    arr = arr.astype(np.float32)
    arr[arr < -30000] = np.nan
    if nodata is not None:
        arr[arr == nodata] = np.nan
    return arr[start_row:end_row, :]


class BiomeDataset:
    def __init__(self, temp_file, temp_std_file, precip_file, precip_std_file,
                 koppen_file, *, length: int, seed: int = 0,
                 lat_min: float = -60.0, lat_max: float = 60.0,
                 input_dropout: float = 0.0):
        self.input_dropout = input_dropout
        arr, transform, _ = read_geotiff(temp_file)
        height = arr.shape[0]
        if transform is not None:
            top = transform.f
            lat_res = -transform.e
        else:
            top, lat_res = 90.0, 180.0 / height
        start_row = int((top - lat_max) / lat_res)
        end_row = int((top - lat_min) / lat_res)
        start_row = max(0, min(start_row, height))
        end_row = max(0, min(end_row, height))
        if start_row >= end_row:
            start_row, end_row = 0, height

        temp = arr.astype(np.float32)[start_row:end_row]
        temp[temp < -30000] = np.nan
        temp_std = _read_band(temp_std_file, start_row, end_row)
        precip = _read_band(precip_file, start_row, end_row)
        precip_std = _read_band(precip_std_file, start_row, end_row)
        koppen, _, _ = read_geotiff(koppen_file)
        koppen = koppen[start_row:end_row]

        n_rows, n_cols = temp.shape
        rng = np.random.default_rng(seed)
        x = np.empty((int(length), 4), np.float32)
        y = np.empty((int(length),), np.int64)
        i = 0
        while i < int(length):
            r = int(rng.integers(0, n_rows))
            c = int(rng.integers(0, n_cols))
            vals = (temp[r, c], temp_std[r, c], precip[r, c], precip_std[r, c])
            k = int(koppen[r, c])
            if k <= 0 or any(np.isnan(v) for v in vals):
                continue
            x[i] = vals
            y[i] = k
            i += 1
        self.x, self.y = x, y
        self.rng = np.random.default_rng(seed + 1)

    def __len__(self):
        return len(self.x)

    def set_seed(self, seed):
        self.rng = np.random.default_rng(int(seed) % 2**63)

    def __getitem__(self, idx):
        x = self.x[idx % len(self.x)].copy()
        if self.input_dropout > 0:
            drop = self.rng.random(4) < self.input_dropout
            x[drop] = 0.0
        return {"image": x, "label": self.y[idx % len(self.y)]}
