"""HDF5-backed training datasets, NumPy-native with NHWC outputs
(counterpart of ``terrain_diffusion_tpu/training/datasets/h5_datasets.py``,
kept as its own copy).

The reference's HDF5 schema
(``{res}/{chunk}/{subchunk}/{latent,lowfreq,lowres_exact,climate,residual}``
with ``pct_land``/``split`` attrs and a per-subchunk ``beauty_score``),
subset weighting, beauty-score stratified sampling, 8-way pre-augmented
latents, D4 augmentation with inverse-transformed source coords, and the
conditioning images.  ``h5py`` is imported only where a file is opened.

Ported: ``H5LatentsDataset`` (with ``val_dset``'s real-DEM ground truth,
which the evaluation reads), ``H5DecoderTerrainDataset``,
``H5AutoencoderDataset``, ``LongDataset``,
``collate`` and ``batch_iterator``.  ``batch_iterator`` yields batches in
index order from one producer thread: the JAX iterator's two workers may
hand over two batches out of order, and a resumed run must see the batches
an uninterrupted one sees.
"""
from __future__ import annotations

import queue
import threading

import numpy as np


LOWFREQ_MEAN = -31.4
LOWFREQ_STD = 38.6


def _d4_inverse_coords(li, lj, lh, lw, size, flip, rotate_k):
    """Inverse-transform crop coords (reference `h5_latents_dataset.py:295-301`)."""
    for _ in range(rotate_k):
        li, lj = lj, size - li - lh
    if flip:
        lj = size - lj - lw
    return li, lj


def _apply_d4(arr, flip, rotate_k):
    """Forward D4 transform on trailing (H, W) axes."""
    if flip:
        arr = arr[..., ::-1]
    if rotate_k:
        arr = np.rot90(arr, k=rotate_k, axes=(-2, -1))
    return np.ascontiguousarray(arr)


def _chw_to_hwc(arr):
    return np.moveaxis(arr, 0, -1)


class _H5SubsetMixin:
    """Shared subset-key scanning over the HDF5 schema."""

    def _scan_keys(self, f, required_dset: str, pct_land_ranges,
                   subset_resolutions, split, beauty_buckets: bool):
        n = len(subset_resolutions)
        keys = [[set() for _ in range(5)] if beauty_buckets else set()
                for _ in range(n)]
        for i, (plr, res) in enumerate(zip(pct_land_ranges, subset_resolutions)):
            plr = plr or [0, 1]
            if str(res) not in f:
                continue
            res_group = f[str(res)]
            for chunk_id in res_group:
                for subchunk_id in res_group[chunk_id]:
                    g = res_group[chunk_id][subchunk_id]
                    if required_dset not in g:
                        continue
                    dset = g[required_dset]
                    ok = plr[0] <= dset.attrs["pct_land"] <= plr[1]
                    ok = ok and (split is None or dset.attrs["split"] == split)
                    if not ok:
                        continue
                    if beauty_buckets:
                        b = float(g.attrs.get("beauty_score", 3.0))
                        b = max(1, min(5, round(b))) - 1
                        keys[i][b].add((chunk_id, res, subchunk_id))
                    else:
                        keys[i].add((chunk_id, res, subchunk_id))
        if beauty_buckets:
            return [[sorted(sub) for sub in k] for k in keys]
        return [sorted(k) for k in keys]


class H5LatentsDataset(_H5SubsetMixin):
    """Base-model training pairs: sampled VAE latents + lowfreq + 58-dim cond."""

    def __init__(self, h5_file, crop_size, pct_land_ranges, subset_resolutions,
                 subset_weights=None, subset_class_labels=None,
                 eval_dataset=False, latents_mean=None, latents_std=None,
                 sigma_data=0.5, clip_edges=True, split=None, beauty_dist=True,
                 residual_mean=None, residual_std=None, cond_input_mean=None,
                 cond_input_std=None, cond_input_dropout=0.0,
                 cond_input_max_noise=0.0, val_dset=False):
        import h5py

        self.h5_file = h5_file
        self.crop_size = crop_size
        self.subset_weights = np.asarray(
            subset_weights if subset_weights is not None
            else [1.0] * len(pct_land_ranges or [[0, 1]]), np.float64)
        self.subset_weights /= self.subset_weights.sum()
        self.subset_class_labels = subset_class_labels
        self.eval_dataset = eval_dataset
        self.latents_mean = np.asarray(latents_mean or [0, 0, 0, 0], np.float32).reshape(-1, 1, 1)
        self.latents_std = np.asarray(latents_std or [1, 1, 1, 1], np.float32).reshape(-1, 1, 1)
        self.sigma_data = sigma_data
        self.clip_edges = clip_edges
        self.val_dset = val_dset
        self.cond_input_dropout = cond_input_dropout
        self.cond_input_max_noise = cond_input_max_noise
        n = len(self.subset_weights)
        if isinstance(beauty_dist, bool):
            beauty_dist = [beauty_dist] * n
        self.beauty_dist = beauty_dist
        self.rng = np.random.default_rng(0)
        with h5py.File(h5_file, "r") as f:
            self.keys = self._scan_keys(f, "latent", pct_land_ranges or [[0, 1]],
                                        subset_resolutions or [480], split, True)
        self.residual_mean = residual_mean
        self.residual_std = residual_std
        self.cond_input_mean = cond_input_mean
        self.cond_input_std = cond_input_std
        if self.cond_input_mean is None:
            self._compute_cond_stats()

    def __len__(self):
        return 100000

    def set_seed(self, seed):
        self.rng = np.random.default_rng(int(seed) % 2**63)

    def _compute_cond_stats(self, n=256):
        vals = []
        for i in range(n):
            vals.append(self.getitem(i, _raw_cond=True)["cond_inputs_img"])
        v = np.stack(vals)  # (n, 7, H, W)
        self.cond_input_mean = [float(np.nanmean(v[:, c])) for c in range(7)]
        v[:, 0] = np.nan_to_num(v[:, 0], nan=self.cond_input_mean[0])
        v[:, 1] = np.nan_to_num(v[:, 1], nan=self.cond_input_mean[1])
        self.cond_input_std = [float(np.std(v[:, 0])), float(np.std(v[:, 1]))] + \
            [float(np.nanstd(v[:, c])) for c in range(2, 7)]

    def _get_cond_image(self, f, group_path, li, lj, lh, lw, flip, rotate_k):
        HALO = 32
        lowres = f[f"{group_path}/lowres_exact"]
        H, W = lowres.shape
        si0, sj0 = li - HALO, lj - HALO
        si1, sj1 = li + lh + HALO, lj + lw + HALO
        ri0, rj0 = max(0, si0), max(0, sj0)
        ri1, rj1 = min(H, si1), min(W, sj1)
        out = np.full((lh + 2 * HALO, lw + 2 * HALO), np.nan, np.float32)
        out_climate = np.full((4, lh + 2 * HALO, lw + 2 * HALO), np.nan, np.float32)
        if ri1 > ri0 and rj1 > rj0:
            di0, dj0 = ri0 - si0, rj0 - sj0
            out[di0:di0 + ri1 - ri0, dj0:dj0 + rj1 - rj0] = lowres[ri0:ri1, rj0:rj1]
            out_climate[:, di0:di0 + ri1 - ri0, dj0:dj0 + rj1 - rj0] = \
                f[f"{group_path}/climate"][[0, 3, 11, 14], ri0:ri1, rj0:rj1]

        out = _apply_d4(out, flip, rotate_k)
        out_climate = _apply_d4(out_climate, flip, rotate_k)

        oh, ow = out.shape[0] // HALO, out.shape[1] // HALO
        blocks = out.reshape(oh, HALO, ow, HALO)
        with np.errstate(invalid="ignore"):
            means = blocks.mean(axis=(1, 3))[None]
            # plain quantile: any block touching the out-of-bounds NaN halo
            # becomes NaN (later mean-imputed) — the reference's exact
            # behavior (h5_latents_dataset.py:199 uses np.quantile)
            p5 = np.quantile(blocks, 0.05, axis=(1, 3))[None]
            climate_means = out_climate.reshape(4, oh, HALO, ow, HALO).mean(axis=(2, 4))
        mask = 1.0 - np.isnan(means).astype(np.float32)

        if self.cond_input_dropout and not self.val_dset:
            keep = self.rng.random(mask.shape) > self.cond_input_dropout
            mask = mask * keep
            means = np.where(mask == 0, np.nan, means)
            p5 = np.where(mask == 0, np.nan, p5)
        if self.cond_input_max_noise and not self.val_dset:
            noise_level = float(self.rng.random())
            nstd = noise_level * self.cond_input_max_noise
            means = means + self.rng.standard_normal(means.shape) * nstd
            p5 = p5 + self.rng.standard_normal(p5.shape) * nstd
        else:
            noise_level = 0.0

        stack = np.concatenate([means, p5, climate_means, mask], axis=0).astype(np.float32)
        if self.cond_input_mean is not None:
            stack[0] = np.nan_to_num(stack[0], nan=self.cond_input_mean[0])
            stack[1] = np.nan_to_num(stack[1], nan=self.cond_input_mean[1])
            m = np.asarray(self.cond_input_mean, np.float32).reshape(-1, 1, 1)
            s = np.asarray(self.cond_input_std, np.float32).reshape(-1, 1, 1)
            stack = (stack - m) / s
        return stack, noise_level

    def build_cond_inputs(self, cond_img, histogram_raw, noise_level):
        nl = (noise_level - 0.5) * np.sqrt(12)
        ch, cw = cond_img.shape[-2] // 2, cond_img.shape[-1] // 2
        means_crop = cond_img[0:1, ch - 2:ch + 2, cw - 2:cw + 2]
        p5_crop = cond_img[1:2, ch - 2:ch + 2, cw - 2:cw + 2]
        climate_crop = cond_img[2:6, ch - 1:ch + 1, cw - 1:cw + 1].mean(axis=(1, 2))
        mask_crop = cond_img[6:7, ch - 2:ch + 2, cw - 2:cw + 2]
        nan_mask = np.isnan(climate_crop)
        climate_crop[nan_mask] = self.rng.standard_normal(int(nan_mask.sum()))
        # pure-NumPy mp_concat (ops/mp.py:80-89): this runs per sample in
        # the loader's worker threads — dispatching jnp ops there would
        # serialize on the device and contend with the training step
        parts = [means_crop.reshape(-1).astype(np.float32),
                 p5_crop.reshape(-1).astype(np.float32),
                 climate_crop.reshape(-1).astype(np.float32),
                 mask_crop.reshape(-1).astype(np.float32),
                 np.asarray(histogram_raw, np.float32),
                 np.asarray([nl], np.float32)]
        k = len(parts)
        wv = np.full((k,), 1.0 / k, np.float64)
        c = np.sqrt(sum(p.size for p in parts) / float(np.sum(wv ** 2)))
        return np.concatenate(
            [p * np.float32(c / np.sqrt(p.size) * wv[i])
             for i, p in enumerate(parts)]).astype(np.float32)

    def getitem(self, idx, _raw_cond=False):
        import h5py

        subset_idx = int(self.rng.choice(len(self.subset_weights), p=self.subset_weights))
        class_label = (self.subset_class_labels[subset_idx]
                       if self.subset_class_labels is not None else None)
        if self.beauty_dist[subset_idx]:
            lens = np.array([len(self.keys[subset_idx][i]) for i in range(5)], np.float64)
            baseline = np.log(np.maximum(lens, 1e-9) / lens.sum())
            histogram_raw = self.rng.standard_normal(5) if not self.val_dset else np.zeros(5)
            logits = histogram_raw + baseline
            probs = np.exp(logits - logits.max())
            probs[lens == 0] = 0
            probs /= probs.sum()
            b = int(self.rng.choice(5, p=probs))
            bucket = self.keys[subset_idx][b]
        else:
            histogram_raw = self.rng.standard_normal(5) if not self.val_dset else np.zeros(5)
            # beauty_dist off: sample uniformly over the WHOLE subset, not
            # just the first beauty bucket (keys are always bucketed)
            bucket = [k for b in self.keys[subset_idx] for k in b]
        chunk_id, res, subchunk_id = bucket[int(self.rng.integers(len(bucket)))]

        with h5py.File(self.h5_file, "r") as f:
            group_path = f"{res}/{chunk_id}/{subchunk_id}"
            data_latent = f[f"{group_path}/latent"]
            data_lowfreq = f[f"{group_path}/lowfreq"]
            shape = data_latent.shape
            cs = self.crop_size
            if not self.eval_dataset:
                if self.clip_edges:
                    if shape[2] - cs <= 1 or shape[3] - cs <= 1:
                        raise ValueError(
                            f"crop_size={cs} leaves no 1-px border in a "
                            f"{shape[2]}x{shape[3]} chunk; use "
                            "clip_edges=False (extrapolated decode) for "
                            "full-chunk crops")
                    i = int(self.rng.integers(1, shape[2] - cs))
                    j = int(self.rng.integers(1, shape[3] - cs))
                else:
                    # crop may equal the full chunk (e.g. full-canvas eval):
                    # offset 0 is then the only valid choice
                    i = int(self.rng.integers(0, shape[2] - cs + 1))
                    j = int(self.rng.integers(0, shape[3] - cs + 1))
            else:
                i = (shape[2] - cs) // 2
                j = (shape[3] - cs) // 2
            h = w = cs
            transform_idx = int(self.rng.integers(8)) if not self.eval_dataset else 0
            flip, rotate_k = transform_idx // 4 == 1, transform_idx % 4
            li, lj = _d4_inverse_coords(i, j, h, w, shape[2], flip, rotate_k)

            lat = np.asarray(data_latent[transform_idx, :, i:i + h, j:j + w], np.float32)
            lc = lat.shape[0]
            means, logvars = lat[:lc // 2], lat[lc // 2:]
            sampled = self.rng.standard_normal(means.shape).astype(np.float32) * \
                np.exp(logvars * 0.5) + means
            sampled = (sampled - self.latents_mean) / self.latents_std * self.sigma_data

            if self.clip_edges:
                lf = np.asarray(data_lowfreq[li - 1:li + h + 1, lj - 1:lj + w + 1], np.float32)[None]
            else:
                lf = np.asarray(data_lowfreq[li:li + h, lj:lj + w], np.float32)[None]
            lf = _apply_d4(lf, flip, rotate_k)
            lowfreq_padded = lf if self.clip_edges else None
            if self.clip_edges:
                lf = lf[..., 1:-1, 1:-1]
            lf = (lf - LOWFREQ_MEAN) / LOWFREQ_STD * self.sigma_data
            ground_truth = self._ground_truth(f, group_path, li, lj, h, w, flip, rotate_k,
                                              lf, lowfreq_padded) if self.val_dset else None

            cond_img, noise_level = self._get_cond_image(
                f, group_path, li, lj, h, w, flip, rotate_k)
            if _raw_cond:
                return {"cond_inputs_img": cond_img}
            cond_vec = self.build_cond_inputs(cond_img, histogram_raw, noise_level)

        image = np.concatenate([sampled, lf], axis=0)
        cond_inputs = [cond_vec]
        if class_label is not None:
            cond_inputs.append(np.asarray(class_label))
        out = {"image": _chw_to_hwc(image).astype(np.float32),
               "cond_inputs": cond_inputs, "cond_inputs_img": cond_img,
               "path": group_path,
               "histogram_raw": histogram_raw, "noise_level": noise_level}
        if ground_truth is not None:
            out["ground_truth"] = _chw_to_hwc(ground_truth)
        return out

    __getitem__ = getitem

    def _ground_truth(self, f, group_path, li, lj, h, w, flip, rotate_k, lf, lowfreq_padded):
        """Real DEM ground truth (``val_dset``): the raw residual crop at x8
        the latent coords, laplacian-decoded against the raw lowfreq -
        signed-sqrt-space terrain at output resolution."""
        import torch

        from terrain_diffusion_tpu_torch.ops.laplacian import laplacian_decode

        if f"{group_path}/residual" not in f:
            raise KeyError(f"{group_path!r} has no 'residual' dataset: val_dset=True needs an "
                           "encoded file built with residuals")
        res8 = np.asarray(f[f"{group_path}/residual"][li * 8:(li + h) * 8, lj * 8:(lj + w) * 8],
                          np.float32)[None]
        res8 = torch.from_numpy(np.ascontiguousarray(_apply_d4(res8, flip, rotate_k)))
        if self.clip_edges:
            gt = laplacian_decode(res8, torch.from_numpy(np.ascontiguousarray(lowfreq_padded)),
                                  pre_padded=True)
        else:
            low = self.denormalize_lowfreq(lf / self.sigma_data)
            gt = laplacian_decode(res8, torch.from_numpy(np.ascontiguousarray(low)),
                                  extrapolate=True)
        return gt.numpy().astype(np.float32)

    @staticmethod
    def denormalize_lowfreq(lowfreq):
        return lowfreq * LOWFREQ_STD + LOWFREQ_MEAN


class H5DecoderTerrainDataset(_H5SubsetMixin):
    """Decoder training pairs: residual crops + nearest-up latent cond image."""

    def __init__(self, h5_file, crop_size, pct_land_ranges, subset_resolutions,
                 subset_weights=None, subset_class_labels=None,
                 eval_dataset=False, clip_edges=True, split=None,
                 residual_mean=None, residual_std=None, sigma_data=0.5):
        import h5py

        if subset_weights is None:
            subset_weights = [1] * len(pct_land_ranges)
        self.h5_file = h5_file
        self.crop_size = crop_size
        assert crop_size % 8 == 0
        self.subset_weights = np.asarray(subset_weights, np.float64)
        self.subset_weights /= self.subset_weights.sum()
        self.subset_class_labels = subset_class_labels
        self.eval_dataset = eval_dataset
        self.clip_edges = clip_edges
        self.sigma_data = sigma_data
        self.rng = np.random.default_rng(0)
        with h5py.File(h5_file, "r") as f:
            self.keys = self._scan_keys(f, "residual", pct_land_ranges,
                                        subset_resolutions, split, False)
        self.residual_mean = residual_mean
        self.residual_std = residual_std
        if self.residual_mean is None or self.residual_std is None:
            self._calculate_stats()

    def _calculate_stats(self, num_samples=256):
        """Streaming mean/std over raw residual crops (Welford equivalent of
        reference `calculate_stats`, h5_decoder_terrain_dataset.py:91-142)."""
        self.residual_mean, self.residual_std = 0.0, 1.0
        count, mean, m2 = 0, 0.0, 0.0
        for _ in range(num_samples):
            x = self[0]["image"] / self.sigma_data  # undo normalization chain
            n = x.size
            bmean = float(x.mean())
            bm2 = float(x.var()) * n
            delta = bmean - mean
            tot = count + n
            mean += delta * n / tot
            m2 += bm2 + delta**2 * count * n / tot
            count = tot
        self.residual_mean = mean
        self.residual_std = float(np.sqrt(m2 / max(count, 1)))

    def __len__(self):
        return max(len(k) for k in self.keys)

    def set_seed(self, seed):
        self.rng = np.random.default_rng(int(seed) % 2**63)

    def __getitem__(self, index):
        import h5py

        subset_idx = int(self.rng.choice(len(self.subset_weights), p=self.subset_weights))
        class_label = (self.subset_class_labels[subset_idx]
                       if self.subset_class_labels is not None else None)
        bucket = self.keys[subset_idx]
        chunk_id, res, subchunk_id = bucket[int(self.rng.integers(len(bucket)))]
        with h5py.File(self.h5_file, "r") as f:
            group_path = f"{res}/{chunk_id}/{subchunk_id}"
            data_latent = f[f"{group_path}/latent"]
            latent_shape = data_latent.shape
            residual_shape = f[f"{group_path}/residual"].shape
            cs8 = self.crop_size // 8
            if not self.eval_dataset:
                if self.clip_edges:
                    i = int(self.rng.integers(1, latent_shape[2] - cs8))
                    j = int(self.rng.integers(1, latent_shape[3] - cs8))
                else:
                    i = int(self.rng.integers(0, latent_shape[2] - cs8 + 1))
                    j = int(self.rng.integers(0, latent_shape[3] - cs8 + 1))
            else:
                i = (latent_shape[2] - cs8) // 2
                j = (latent_shape[3] - cs8) // 2
            h = w = cs8
            li, lj, lh, lw = i * 8, j * 8, h * 8, w * 8
            transform_idx = int(self.rng.integers(8)) if not self.eval_dataset else 0
            flip, rotate_k = transform_idx // 4 == 1, transform_idx % 4
            li, lj = _d4_inverse_coords(li, lj, lh, lw, residual_shape[1], flip, rotate_k)

            # read lowfreq at the INVERSE coords like the residual, so the
            # forward D4 lands it on the same map window.  The reference's
            # decoder dataset reads lowfreq at the forward coords
            # (h5_decoder_terrain_dataset.py:198) — misaligned with its own
            # residual for 7 of 8 transforms; its latents dataset does the
            # inverse-coords read (h5_latents_dataset.py:190-196), which is
            # the correct behavior this port follows.
            lf_size = f[f"{group_path}/lowfreq"].shape[1]
            if self.clip_edges:
                pi, pj = _d4_inverse_coords(i - 1, j - 1, h + 2, w + 2,
                                            lf_size, flip, rotate_k)
                lf = np.asarray(
                    f[f"{group_path}/lowfreq"][pi:pi + h + 2, pj:pj + w + 2],
                    np.float32)[None]
            else:
                pi, pj = _d4_inverse_coords(i, j, h, w, lf_size, flip,
                                            rotate_k)
                lf = np.asarray(
                    f[f"{group_path}/lowfreq"][pi:pi + h, pj:pj + w],
                    np.float32)[None]
            lf = _apply_d4(lf, flip, rotate_k)
            lowfreq_padded = lf if self.clip_edges else None
            if self.clip_edges:
                lf = lf[..., 1:-1, 1:-1]

            lat = np.asarray(data_latent[transform_idx, :, i:i + h, j:j + w], np.float32)
            lc = lat.shape[0]
            means, logvars = lat[:lc // 2], lat[lc // 2:]
            sampled = self.rng.standard_normal(means.shape).astype(np.float32) * \
                np.exp(logvars * 0.5) + means

            residual = np.asarray(f[f"{group_path}/residual"][li:li + lh, lj:lj + lw],
                                  np.float32)[None]
            residual = (residual - self.residual_mean) / self.residual_std
            residual = _apply_d4(residual, flip, rotate_k)

        image = residual * self.sigma_data
        cond_image = np.repeat(np.repeat(sampled, 8, axis=1), 8, axis=2)
        cond_inputs = [np.asarray(class_label)] if class_label is not None else []
        out = {"image": _chw_to_hwc(image).astype(np.float32),
               "cond_img": _chw_to_hwc(cond_image).astype(np.float32),
               "cond_inputs": cond_inputs, "path": group_path,
               "lowfreq": _chw_to_hwc(lf).astype(np.float32)}
        if lowfreq_padded is not None:
            out["lowfreq_padded"] = _chw_to_hwc(lowfreq_padded).astype(np.float32)
        return out

    def denormalize_residual(self, residual):
        return residual * self.residual_std + self.residual_mean


class H5AutoencoderDataset(_H5SubsetMixin):
    """Residual crops for VAE training: 8-aligned crops (centred for
    ``eval_dataset``), D4 augmentation, normalization by ``residual_mean`` /
    ``residual_std``, optionally squared back out of signed-sqrt space, times
    ``sigma_data``."""

    def __init__(self, h5_file, crop_size, pct_land_ranges, subset_resolutions,
                 subset_weights=None, eval_dataset=False, split=None,
                 residual_mean=0.0, residual_std=1.0, sigma_data=0.5,
                 square_elevation: bool = False, signed_sqrt=None):
        import h5py

        # the config spelling (autoencoder_x8_squared.cfg): signed_sqrt=false
        # trains on raw-meter (squared-back) residuals
        if signed_sqrt is not None:
            square_elevation = not signed_sqrt
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
        self.square_elevation = square_elevation
        self.rng = np.random.default_rng(0)
        with h5py.File(h5_file, "r") as f:
            self.keys = self._scan_keys(f, "residual", pct_land_ranges,
                                        subset_resolutions, split, False)

    def __len__(self):
        return max(len(k) for k in self.keys)

    def set_seed(self, seed):
        self.rng = np.random.default_rng(int(seed) % 2**63)

    def __getitem__(self, index):
        import h5py

        subset_idx = int(self.rng.choice(len(self.subset_weights), p=self.subset_weights))
        bucket = self.keys[subset_idx]
        chunk_id, res, subchunk_id = bucket[int(self.rng.integers(len(bucket)))]
        with h5py.File(self.h5_file, "r") as f:
            group_path = f"{res}/{chunk_id}/{subchunk_id}"
            residual = f[f"{group_path}/residual"]
            H, W = residual.shape
            cs = self.crop_size
            if not self.eval_dataset:
                i = int(self.rng.integers(0, (H - cs) // 8 + 1)) * 8
                j = int(self.rng.integers(0, (W - cs) // 8 + 1)) * 8
            else:
                i = (H - cs) // 2 // 8 * 8
                j = (W - cs) // 2 // 8 * 8
            crop = np.asarray(residual[i:i + cs, j:j + cs], np.float32)[None]
        transform_idx = int(self.rng.integers(8)) if not self.eval_dataset else 0
        crop = _apply_d4(crop, transform_idx // 4 == 1, transform_idx % 4)
        crop = (crop - self.residual_mean) / self.residual_std
        if self.square_elevation:
            crop = np.sign(crop) * np.square(crop)
        image = crop * self.sigma_data
        return {"image": _chw_to_hwc(image).astype(np.float32),
                "cond_inputs": [], "path": group_path}


class LongDataset:
    """Infinite wrapper: per-epoch permutation reseed + per-sample seeds
    (reference `long_dataset.py:7-46`)."""

    def __init__(self, base_dataset, length: int = 10**12, shuffle: bool = True,
                 base_seed: int = 0):
        self.base = base_dataset
        self.length = length
        self.shuffle = shuffle
        self.base_seed = base_seed

    def __len__(self):
        return self.length

    def __getitem__(self, idx):
        n = len(self.base)
        epoch, pos = divmod(idx, n)
        if self.shuffle:
            perm = np.random.default_rng(self.base_seed + epoch).permutation(n)
            pos = int(perm[pos])
        if hasattr(self.base, "set_seed"):
            self.base.set_seed(self.base_seed * 1_000_003 + idx)
        return self.base[pos]


def collate(samples: list) -> dict:
    """Stack a list of sample dicts into a batch dict (numpy)."""
    out = {}
    keys = samples[0].keys()
    for k in keys:
        v0 = samples[0][k]
        if isinstance(v0, np.ndarray):
            out[k] = np.stack([s[k] for s in samples])
        elif isinstance(v0, list):  # cond_inputs: list of arrays
            out[k] = [np.stack([np.asarray(s[k][i]) for s in samples])
                      for i in range(len(v0))]
        elif isinstance(v0, (int, float, np.floating)):
            out[k] = np.asarray([s[k] for s in samples])
        else:
            out[k] = [s[k] for s in samples]
    return out


def batch_iterator(dataset, batch_size: int, start: int = 0, prefetch: int = 2):
    """Host-side prefetching batch iterator: one producer thread fetches and
    collates batches ``start``, ``start + batch_size``, ... in order while
    the consumer trains; an exception in the producer is raised to the
    consumer.  The thread stops when the generator is closed."""
    q: "queue.Queue" = queue.Queue(maxsize=max(prefetch, 1))
    stop = threading.Event()

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def worker():
        i0 = start
        while not stop.is_set():
            try:
                batch = collate([dataset[i0 + k] for k in range(batch_size)])
            except Exception as e:  # surfaced to the consumer
                put(e)
                return
            if not put(batch):
                return
            i0 += batch_size

    thread = threading.Thread(target=worker, daemon=True)
    thread.start()
    try:
        while True:
            item = q.get()
            if isinstance(item, Exception):
                raise item
            yield item
    finally:
        stop.set()
        thread.join(timeout=10)
