"""Random raster crops for the GAN trainer (counterpart of
``terrain_diffusion_tpu/training/datasets/file_gan_dataset.py``)."""
from __future__ import annotations

import glob
import os

import numpy as np

from terrain_diffusion_tpu_torch.common.geotiff import read_geotiff


class FileGANDataset:
    def __init__(self, root_dir, crop_size: int, pattern: str = "*.tif",
                 normalize: bool = True, signed_sqrt: bool = True):
        self.files = sorted(glob.glob(os.path.join(root_dir, pattern)))
        if not self.files:
            raise FileNotFoundError(f"no rasters matching {pattern} in {root_dir}")
        self.crop_size = crop_size
        self.normalize = normalize
        self.signed_sqrt = signed_sqrt
        self.rng = np.random.default_rng(0)

    def __len__(self):
        return len(self.files) * 64

    def set_seed(self, seed):
        self.rng = np.random.default_rng(int(seed) % 2**63)

    def __getitem__(self, idx):
        path = self.files[int(self.rng.integers(len(self.files)))]
        arr, _, nodata = read_geotiff(path)
        arr = arr.astype(np.float32)
        if nodata is not None:
            arr = np.where(arr == nodata, 0.0, arr)
        cs = self.crop_size
        h, w = arr.shape
        i = int(self.rng.integers(0, max(h - cs, 0) + 1))
        j = int(self.rng.integers(0, max(w - cs, 0) + 1))
        crop = arr[i:i + cs, j:j + cs]
        if crop.shape != (cs, cs):
            crop = np.pad(crop, ((0, cs - crop.shape[0]), (0, cs - crop.shape[1])))
        if self.signed_sqrt:
            crop = np.sign(crop) * np.sqrt(np.abs(crop))
        if self.normalize:
            crop = (crop - crop.mean()) / (crop.std() + 1e-6)
        return {"image": crop[..., None], "cond_inputs": []}
