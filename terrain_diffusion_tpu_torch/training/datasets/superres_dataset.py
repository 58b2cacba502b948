"""Superres terrain dataset (counterpart of
``terrain_diffusion_tpu/training/datasets/superres_dataset.py``): the image
is a residual crop, its conditioning the crop averaged down by
``downsample_factor`` and repeated back up.  No shipped config uses it."""
from __future__ import annotations

import numpy as np

from terrain_diffusion_tpu_torch.training.datasets.h5_datasets import (
    _apply_d4,
    _chw_to_hwc,
    _H5SubsetMixin,
)


class H5SuperresTerrainDataset(_H5SubsetMixin):
    def __init__(self, h5_file, crop_size, pct_land_ranges, subset_resolutions,
                 subset_weights=None, eval_dataset=False, split=None,
                 residual_mean=0.0, residual_std=1.0, sigma_data=0.5,
                 downsample_factor: int = 2):
        import h5py

        if subset_weights is None:
            subset_weights = [1] * len(pct_land_ranges)
        self.h5_file = h5_file
        self.crop_size = crop_size
        self.subset_weights = np.asarray(subset_weights, np.float64)
        self.subset_weights /= self.subset_weights.sum()
        self.eval_dataset = eval_dataset
        self.sigma_data = sigma_data
        self.residual_mean = residual_mean
        self.residual_std = residual_std
        self.downsample_factor = downsample_factor
        self.rng = np.random.default_rng(0)
        with h5py.File(h5_file, "r") as f:
            self.keys = self._scan_keys(f, "residual", pct_land_ranges,
                                        subset_resolutions, split, False)

    def __len__(self):
        return max(len(k) for k in self.keys)

    def set_seed(self, seed):
        self.rng = np.random.default_rng(int(seed) % 2**63)

    def __getitem__(self, idx):
        import h5py

        subset_idx = int(self.rng.choice(len(self.subset_weights), p=self.subset_weights))
        bucket = self.keys[subset_idx]
        chunk_id, res, subchunk_id = bucket[int(self.rng.integers(len(bucket)))]
        with h5py.File(self.h5_file, "r") as f:
            g = f"{res}/{chunk_id}/{subchunk_id}"
            residual = f[f"{g}/residual"]
            H, W = residual.shape
            cs = self.crop_size
            if not self.eval_dataset:
                i = int(self.rng.integers(0, H - cs + 1))
                j = int(self.rng.integers(0, W - cs + 1))
            else:
                i, j = (H - cs) // 2, (W - cs) // 2
            crop = np.asarray(residual[i:i + cs, j:j + cs], np.float32)[None]
        transform_idx = int(self.rng.integers(8)) if not self.eval_dataset else 0
        crop = _apply_d4(crop, transform_idx // 4 == 1, transform_idx % 4)
        crop = (crop - self.residual_mean) / self.residual_std * self.sigma_data
        k = self.downsample_factor
        low = crop.reshape(1, cs // k, k, cs // k, k).mean(axis=(2, 4))
        cond = np.repeat(np.repeat(low, k, axis=1), k, axis=2)
        return {"image": _chw_to_hwc(crop).astype(np.float32),
                "cond_img": _chw_to_hwc(cond).astype(np.float32),
                "cond_inputs": []}
