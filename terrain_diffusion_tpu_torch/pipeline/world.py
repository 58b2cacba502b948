"""WorldPipeline: 3-stage lazy hierarchical terrain generation in PyTorch.

Counterpart of ``terrain_diffusion_tpu.pipeline.world`` (serving path):

- coarse stage: 64-px tiles / stride 48, 20-step DPM-Solver++ over the
  coarse U-Net, conditioned on the synthetic map mixed with deterministic
  noise via TrigFlow cos/sin at per-channel SNR;
- latent stage: 64-px latent tiles / stride 32, T=2 TrigFlow consistency
  steps (init + one intermediate step), each tile conditioned on a 58-dim
  vector built from its 4x4 coarse context window;
- decoder stage: 512-px tiles / stride 384, one consistency step on the
  x8-nearest-upsampled latents; its residual blocks and in/out convs run
  through the hand-written CUDA kernels on the card;
- output composition: Laplacian denoise + decode + signed square for
  elevation; windowed temperature regression + bilinear grid-sample for
  climate.

Every stage evaluates a whole padded tile batch as one tensor with a real
batch dimension.  Stochastic inputs come from the portable PCG64 noise
field, keyed on (seed, stage, tile), so any tile is identical regardless of
batch composition or evaluation order.
"""
from __future__ import annotations

import json
import os
import time

import numpy as np
import torch

from terrain_diffusion_tpu_torch import use_full_f32
from terrain_diffusion_tpu_torch.nn import torch_compat
from terrain_diffusion_tpu_torch.ops import mp
from terrain_diffusion_tpu_torch.ops.image import (avg_pool, grid_sample_bilinear,
                                                   max_pool, min_pool, signed_square,
                                                   upsample_nearest)
from terrain_diffusion_tpu_torch.ops.laplacian import laplacian_decode, laplacian_denoise
from terrain_diffusion_tpu_torch.ops.noise_field import gaussian_noise_patch
from terrain_diffusion_tpu_torch.ops.rng_portable import next_seed
from terrain_diffusion_tpu_torch.ops.windows import linear_weight_window
from terrain_diffusion_tpu_torch.pipeline.postprocessing import local_baseline_temperature
from terrain_diffusion_tpu_torch.pipeline.synthetic_map import make_synthetic_map_factory
from terrain_diffusion_tpu_torch.runtime.infinite_tensor import (InfiniteTensor,
                                                                 ensure_regions_multi)
from terrain_diffusion_tpu_torch.runtime.tile_store import MemoryTileStore
from terrain_diffusion_tpu_torch.runtime.window import TensorWindow
from terrain_diffusion_tpu_torch.scheduler.dpmsolver import (EDMSchedulerConfig,
                                                             compute_sigmas, sample_dpm,
                                                             trigflow_precondition_noise)

# Channel statistics the reference bakes into the pipeline.
DEFAULT_COARSE_MEANS = [-37.67916460232751, 2.22578822145657, 18.030293275011356,
                        333.8442390481231, 1350.1259248456176, 52.444339366764396]
DEFAULT_COARSE_STDS = [39.68515115440358, 3.0981253981231522, 8.940333096712806,
                       322.25238547630295, 856.3430083394657, 30.982620765341043]
COND_INPUT_MEAN = np.array([14.99, 11.65, 15.87, 619.26, 833.12, 69.40, 0.66], np.float32)
COND_INPUT_STD = np.array([21.72, 21.78, 10.40, 452.29, 738.09, 34.59, 0.47], np.float32)
LOWFREQ_MEAN = -31.4
LOWFREQ_STD = 38.6
SCHED = EDMSchedulerConfig(sigma_min=0.002, sigma_max=80, sigma_data=0.5)
SD = SCHED.sigma_data


def _ceil_div(a, b):
    return -((-a) // b)


class WorldPipeline:
    """Multi-scale terrain generation pipeline (PyTorch)."""

    COARSE_MODEL_FOLDER = "coarse_model"
    BASE_MODEL_FOLDER = "base_model"
    DECODER_MODEL_FOLDER = "decoder_model"
    CONFIG_NAME = "config.json"

    def __init__(self, seed: int | None = None,
                 latents_batch_size=(1, 2, 4, 8, 16, 32, 64),
                 native_resolution: float = 90.0, *, T: int = 2,
                 log_mode: str = "info", dtype: str | None = None,
                 latent_compression: int = 8, frequency_mult=None,
                 drop_water_pct: float = 0.5, cond_snr=None, coarse_pooling: int = 1,
                 elev_coarse_pool_mode: str = "avg", p5_coarse_pool_mode: str = "avg",
                 residual_mean: float = 0.0, residual_std: float = 1.1678,
                 coarse_means=None, coarse_stds=None,
                 caching_strategy: str = "direct",
                 cache_limit: int | None = 100 * 1024 * 1024,
                 onestep_latent: bool = False, decoder_tile_size: int = 512,
                 decoder_tile_stride: int = 384, noise_mode: str = "threefry",
                 device="cpu", **deprecated_kwargs):
        if T not in (1, 2):
            raise ValueError(f"T must be 1 or 2, got {T}")
        if T == 1 or onestep_latent:
            raise NotImplementedError("T=1 / onestep_latent are not ported yet")
        if noise_mode != "portable":
            raise NotImplementedError(
                f"noise_mode={noise_mode!r} is not ported; use noise_mode='portable'")
        if dtype not in (None, "fp32"):
            raise NotImplementedError(f"dtype={dtype!r}: the port serves float32 only")
        if caching_strategy != "direct":
            raise NotImplementedError("only caching_strategy='direct' is ported")
        use_full_f32()
        self.T = T
        self.seed = (int(seed) & 0xFFFFFFFFFFFFFFFF) if seed is not None else next_seed(None)
        self._batch_sizes = ([latents_batch_size] if isinstance(latents_batch_size, int)
                             else sorted(latents_batch_size))
        self.native_resolution = native_resolution
        self.latent_compression = latent_compression
        self.log_mode = log_mode
        self.caching_strategy = caching_strategy
        self.cache_limit = cache_limit
        self.onestep_latent = onestep_latent
        self.decoder_tile_size = decoder_tile_size
        self.decoder_tile_stride = decoder_tile_stride
        self.noise_mode = noise_mode
        self.device = torch.device(device)
        self.kwargs = {
            "latent_compression": latent_compression,
            "frequency_mult": list(frequency_mult) if frequency_mult is not None else [1.5, 3, 3, 3, 3],
            "drop_water_pct": drop_water_pct,
            "cond_snr": list(cond_snr) if cond_snr is not None else [0.3, 0.1, 1.0, 0.1, 1.0],
            "coarse_pooling": coarse_pooling,
            "elev_coarse_pool_mode": elev_coarse_pool_mode,
            "p5_coarse_pool_mode": p5_coarse_pool_mode,
            "histogram_raw": deprecated_kwargs.get("histogram_raw") or [0.0] * 5,
            "residual_mean": residual_mean,
            "residual_std": residual_std,
            "coarse_means": list(coarse_means) if coarse_means is not None else list(DEFAULT_COARSE_MEANS),
            "coarse_stds": list(coarse_stds) if coarse_stds is not None else list(DEFAULT_COARSE_STDS),
        }
        self.coarse_model = self.base_model = self.decoder_model = None
        self.tile_store = None
        self.synthetic_map_factory = None
        self.coarse = self.latents = self.residual = None
        self.stage_timings = {}

    # ==================================================================
    # Model IO
    # ==================================================================
    @classmethod
    def from_pretrained(cls, path: str, **kwargs) -> "WorldPipeline":
        with open(os.path.join(path, cls.CONFIG_NAME)) as f:
            config = json.load(f)
        config.pop("_class_name", None)
        config.update(kwargs)
        pipe = cls(**config)
        return pipe.set_models(*(torch_compat.load_model(os.path.join(path, folder),
                                                         device=pipe.device)
                                 for folder in (cls.COARSE_MODEL_FOLDER,
                                                cls.BASE_MODEL_FOLDER,
                                                cls.DECODER_MODEL_FOLDER)))

    def set_models(self, coarse, base, decoder):
        """Attach the three stage models (``EDMUnet2D`` modules)."""
        self.coarse_model, self.base_model, self.decoder_model = (
            m.to(self.device).eval() for m in (coarse, base, decoder))
        if self.tile_store is not None:
            self._build_hierarchy()  # window fns must see the new models
        return self

    # ==================================================================
    # Bind / lifecycle
    # ==================================================================
    def bind(self, hdf5_file=None):
        if hdf5_file is not None:
            raise NotImplementedError("the HDF5 tile store is not ported")
        self.tile_store = MemoryTileStore(cache_size_bytes=self.cache_limit)
        self._init_conditioning()
        self._build_hierarchy()
        return self

    def _init_conditioning(self):
        self.synthetic_map_factory = make_synthetic_map_factory(
            seed=self.seed, frequency_mult=self.kwargs["frequency_mult"],
            drop_water_pct=self.kwargs["drop_water_pct"])

    def _build_hierarchy(self):
        self.coarse = self._build_coarse_stage()
        self.latents = self._build_latent_stage()
        self.residual = self._build_decoder_stage()

    def rebuild(self):
        if self.tile_store is None:
            return
        self.tile_store = MemoryTileStore(cache_size_bytes=self.cache_limit)
        self._init_conditioning()
        self._build_hierarchy()

    def change_seed(self, seed: int | None = None) -> bool:
        new_seed = (int(seed) & 0xFFFFFFFFFFFFFFFF) if seed is not None else next_seed(None)
        if new_seed == self.seed:
            return False
        self.seed = new_seed
        self.rebuild()
        return True

    # ==================================================================
    # Observability
    # ==================================================================
    def _timed(self, stage: str, fn):
        """Run fn, adding its wall time to `stage_timings`; on the card the
        stage's device work is waited for, so the time is the stage's own."""
        t0 = time.perf_counter()
        out = fn()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        dt = time.perf_counter() - t0
        agg = self.stage_timings.setdefault(stage, [0, 0.0])
        agg[0] += 1
        agg[1] += dt
        if self.log_mode == "verbose":
            print(f"[{stage}] {dt * 1000:.1f} ms")
        return out

    def timing_summary(self) -> dict:
        return {k: {"calls": v[0], "total_s": v[1], "mean_ms": v[1] / max(v[0], 1) * 1000}
                for k, v in self.stage_timings.items()}

    # ==================================================================
    # Helpers
    # ==================================================================
    def _tensor(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a, np.float32), device=self.device)

    def _noise(self, seed, y0, x0, h, w, channels, tile):
        return gaussian_noise_patch(seed, y0, x0, h, w, channels, tile, tile)

    # ==================================================================
    # Coarse stage
    # ==================================================================
    def _build_coarse_stage(self):
        TILE, STRIDE = 64, 48
        pool = self.kwargs["coarse_pooling"]
        if TILE % pool or STRIDE % pool:
            raise ValueError(f"coarse_pooling {pool} must divide {TILE} and {STRIDE}")
        sigmas0 = float(compute_sigmas(SCHED, 20)[0])
        means = np.asarray(self.kwargs["coarse_means"], np.float32)
        stds = np.asarray(self.kwargs["coarse_stds"], np.float32)
        cond_means = means[[0, 2, 3, 4, 5]]
        cond_stds = stds[[0, 2, 3, 4, 5]]
        t_cond = np.arctan(np.asarray(self.kwargs["cond_snr"], np.float32))
        cond_scalar_vals = np.log(np.tan(t_cond) / 8.0)
        wwin = self._tensor(linear_weight_window(TILE // pool))
        tc = self._tensor(t_cond).reshape(1, -1, 1, 1)
        means_t = self._tensor(means).reshape(1, -1, 1, 1)
        stds_t = self._tensor(stds).reshape(1, -1, 1, 1)
        pool_fns = [{"max": max_pool, "min": min_pool}.get(m, avg_pool)
                    for m in (self.kwargs["elev_coarse_pool_mode"],
                              self.kwargs["p5_coarse_pool_mode"])]
        model = self.coarse_model

        def f(ctxs):
            seed = self.seed
            conds, cns, sns = [], [], []
            for _, i, j in ctxs:
                i1 = (int(i) * (STRIDE // pool)) * pool
                j1 = (int(j) * (STRIDE // pool)) * pool
                cond = self.synthetic_map_factory(i1, j1, i1 + TILE, j1 + TILE)
                conds.append((cond - cond_means[:, None, None]) / cond_stds[:, None, None])
                cns.append(self._noise(seed, i1, j1, TILE, TILE, 5, TILE))
                sns.append(self._noise(seed + 1, i1, j1, TILE, TILE, 6, TILE))
            B = len(ctxs)
            cond = self._tensor(np.stack(conds))
            cond_img = torch.cos(tc) * cond + torch.sin(tc) * self._tensor(np.stack(cns))
            x = self._tensor(np.stack(sns)) * sigmas0
            cond_scalars = [torch.full((B,), float(v), device=self.device)
                            for v in cond_scalar_vals]

            def model_fn(scaled, sigma):
                label = float(trigflow_precondition_noise(sigma, SD))
                x_in = torch.cat([scaled, cond_img], dim=1).permute(0, 2, 3, 1)
                out = model(x_in, torch.full((B,), label, device=self.device),
                            cond_scalars)
                return out.permute(0, 3, 1, 2).float()

            sample = sample_dpm(model_fn, x, SCHED, 20) / SD
            sample = sample * stds_t + means_t
            sample = torch.cat([sample[:, :1], sample[:, :1] - sample[:, 1:2],
                                sample[:, 2:]], dim=1)
            if pool > 1:
                sample = torch.cat([pool_fns[0](sample[:, 0:1], pool),
                                    pool_fns[1](sample[:, 1:2], pool),
                                    avg_pool(sample[:, 2:], pool)], dim=1)
            return torch.cat([sample * wwin, wwin.expand(B, 1, *wwin.shape)], dim=1)

        buckets = (1, 2, 4, 8, 16, 32)
        return InfiniteTensor(
            lambda ctxs: self._timed("coarse", lambda: f(ctxs)),
            TensorWindow((7, TILE // pool, TILE // pool), (7, STRIDE // pool, STRIDE // pool)),
            batch_buckets=buckets, tile_store=self.tile_store,
            tensor_id="base_coarse_map", device=self.device)

    # ==================================================================
    # Latent stage
    # ==================================================================
    def _build_cond(self, coarse_regions):
        """(B, 58) conditioning vectors from (B, 7, 4, 4) coarse windows.

        Every NaN (in every channel) is filled with COND_INPUT_MEAN[0] in
        normalized space - the reference's production behaviour."""
        B = coarse_regions.shape[0]
        vals = coarse_regions[:, :-1] / coarse_regions[:, -1:]
        cond = torch.cat([vals, torch.ones((B, 1, 4, 4), device=self.device)], dim=1)
        cond = ((cond - self._tensor(COND_INPUT_MEAN).reshape(1, 7, 1, 1))
                / self._tensor(COND_INPUT_STD).reshape(1, 7, 1, 1))
        cond = torch.nan_to_num(cond, nan=float(COND_INPUT_MEAN[0]))
        hist = self._tensor(self.kwargs["histogram_raw"]).expand(B, -1)
        noise_level = torch.full((B, 1), (0.0 - 0.5) * np.sqrt(12), device=self.device)
        return mp.mp_concat(
            [cond[:, 0].reshape(B, -1), cond[:, 1].reshape(B, -1),
             cond[:, 2:6, 1:3, 1:3].mean(dim=(2, 3)), cond[:, 6].reshape(B, -1),
             hist, noise_level], dim=1)

    def _latent_fn(self, t_value: float, seed_offset: int, with_prev: bool):
        TILE, STRIDE = 64, 32
        model = self.base_model
        wwin = self._tensor(linear_weight_window(TILE))
        t = torch.tensor(t_value, dtype=torch.float32, device=self.device)

        def f(ctxs, *regions):
            prevs, coarses = regions if with_prev else (None, regions[0])
            B = len(ctxs)
            z = self._tensor(np.stack([
                self._noise(self.seed + seed_offset, int(c[1]) * STRIDE,
                            int(c[2]) * STRIDE, TILE, TILE, 5, TILE) for c in ctxs]))
            prev = (prevs[:, :-1] / prevs[:, -1:] * SD if with_prev
                    else torch.zeros((B, 5, TILE, TILE), device=self.device))
            x_t = torch.cos(t) * prev + torch.sin(t) * (z * SD)
            x_in = (x_t / SD).permute(0, 2, 3, 1)
            pred = -model(x_in, t.expand(B), [self._build_cond(coarses)])
            pred = pred.permute(0, 3, 1, 2).float()
            sample = (torch.cos(t) * x_t - torch.sin(t) * SD * pred) / SD
            return torch.cat([sample * wwin, wwin.expand(B, 1, TILE, TILE)], dim=1)

        stage = "latent_step" if with_prev else "latent_init"
        return lambda ctxs, *regions: self._timed(stage, lambda: f(ctxs, *regions))

    def _build_latent_stage(self):
        TILE, STRIDE = 64, 32
        sigmas0 = float(compute_sigmas(SCHED, 20)[0])
        t_init = float(np.arctan(sigmas0 / SD))
        t_inter = [float(np.arctan(0.35 / 0.5))]
        out_win = TensorWindow((6, TILE, TILE), (6, STRIDE, STRIDE))
        coarse_win = TensorWindow((7, 4, 4), (7, 1, 1), offset=(0, -1, -1))
        kw = dict(batch_buckets=self._batch_sizes, tile_store=self.tile_store,
                  device=self.device)
        tensor = InfiniteTensor(
            self._latent_fn(t_init, 5819, with_prev=False), out_win,
            args=(self.coarse,), args_windows=(coarse_win,),
            tensor_id="init_latent_map", **kw)
        for i, t in enumerate(t_inter):
            tensor = InfiniteTensor(
                self._latent_fn(t, 5820 + i, with_prev=True), out_win,
                args=(tensor, self.coarse), args_windows=(out_win, coarse_win),
                tensor_id=f"step_latent_map_{i}", **kw)
        return tensor

    # ==================================================================
    # Decoder stage
    # ==================================================================
    def _build_decoder_stage(self):
        TILE = self.decoder_tile_size
        STRIDE = self.decoder_tile_stride
        lc = self.latent_compression
        sigmas0 = float(compute_sigmas(SCHED, 20)[0])
        t_list = [float(np.arctan(sigmas0 / SD))]
        wwin = self._tensor(linear_weight_window(TILE))
        model = self.decoder_model

        def f(ctxs, latents_regions):
            B = len(ctxs)
            lat = (latents_regions[:, :-1] / latents_regions[:, -1:])[:, :4]
            up = upsample_nearest(lat, lc)  # (B, 4, TILE, TILE)
            sample = torch.zeros((B, 1, TILE, TILE), device=self.device)
            for step, t_val in enumerate(t_list):
                # the reference reuses the latent stage's seed offsets here
                z = self._tensor(np.stack([
                    self._noise(self.seed + 5819 + step, int(c[1]) * STRIDE,
                                int(c[2]) * STRIDE, TILE, TILE, 1, TILE) for c in ctxs]))
                t = torch.tensor(t_val, dtype=torch.float32, device=self.device)
                x_t = torch.cos(t) * sample + torch.sin(t) * (z * SD)
                x_in = torch.cat([x_t / SD, up], dim=1).permute(0, 2, 3, 1).contiguous()
                pred = -model(x_in, t.expand(B), [])
                pred = pred.permute(0, 3, 1, 2).float()
                sample = torch.cos(t) * x_t - torch.sin(t) * SD * pred
            sample = sample / SD
            return torch.cat([sample * wwin, wwin.expand(B, 1, TILE, TILE)], dim=1)

        return InfiniteTensor(
            lambda ctxs, regions: self._timed("decoder", lambda: f(ctxs, regions)),
            TensorWindow((2, TILE, TILE), (2, STRIDE, STRIDE)),
            args=(self.latents,),
            args_windows=(TensorWindow((6, TILE // lc, TILE // lc),
                                       (6, STRIDE // lc, STRIDE // lc)),),
            batch_buckets=(1, 2, 4, 8, 16), tile_store=self.tile_store,
            tensor_id="init_residual_map", device=self.device)

    # ==================================================================
    # Output composition
    # ==================================================================
    @staticmethod
    def _elev_ranges(i1, j1, i2, j2, scale: int):
        """(residual_ranges, latents_ranges, pi1, pj1) read regions for an
        elevation query; the region size depends only on the query size."""
        sigma = 5
        kernel_size = (int(sigma * 2) // 2) * 2 + 1
        pad_hr = (kernel_size // 2 + 1) * scale
        pi1 = ((i1 - pad_hr) // scale) * scale
        pj1 = ((j1 - pad_hr) // scale) * scale
        pi2 = pi1 + _ceil_div(i2 - i1 + 2 * pad_hr + scale - 1, scale) * scale
        pj2 = pj1 + _ceil_div(j2 - j1 + 2 * pad_hr + scale - 1, scale) * scale
        return ([(0, 2), (pi1, pi2), (pj1, pj2)],
                [(0, 6), (pi1 // scale, pi2 // scale), (pj1 // scale, pj2 // scale)],
                pi1, pj1)

    @staticmethod
    def _climate_ranges(i1, j1, i2, j2, scale: int):
        """Coarse read region for a climate query."""
        S = 32 * scale
        pad = (15 - 1) // 2 + 1
        return [(0, 7), (i1 // S - pad, _ceil_div(i2, S) + pad),
                (j1 // S - pad, _ceil_div(j2, S) + pad)]

    def _compute_elev(self, i1, j1, i2, j2, scale: int) -> torch.Tensor:
        """Elevation in meters for [i1:i2) x [j1:j2)."""
        res_ranges, lat_ranges, pi1, pj1 = self._elev_ranges(i1, j1, i2, j2, scale)
        residual = self.residual.read(res_ranges)
        latents = self.latents.read(lat_ranges)
        residual_p = (residual[0] / residual[1]) * self.kwargs["residual_std"] \
            + self.kwargs["residual_mean"]
        lowfreq_p = (latents[:-1] / latents[-1:])[4] * LOWFREQ_STD + LOWFREQ_MEAN
        r, lo = laplacian_denoise(residual_p[None], lowfreq_p[None], sigma=5)
        elev_p = laplacian_decode(r, lo)[0]
        oi, oj = i1 - pi1, j1 - pj1
        return signed_square(elev_p[oi:oi + i2 - i1, oj:oj + j2 - j1])

    def _compute_climate(self, i1, j1, i2, j2, elev: torch.Tensor, scale: int) -> torch.Tensor:
        """(5, H, W) climate [temp, t_season, precip, p_cv, beta]."""
        S = 32 * scale
        win = 15
        ci1, cj1 = i1 // S, j1 // S
        coarse = self.coarse.read(self._climate_ranges(i1, j1, i2, j2, scale))
        ii, jj = np.meshgrid(np.arange(i1, i2), np.arange(j1, j2), indexing="ij")
        u = self._tensor((ii + 0.5) / S - ci1 + 0.5)
        v = self._tensor((jj + 0.5) / S - cj1 + 0.5)
        coarse_map = coarse[:-1] / coarse[-1:]
        coarse_elev = torch.sign(coarse_map[0]) * torch.square(torch.clamp(coarse_map[0], min=0.0))
        temp_baseline, beta = local_baseline_temperature(
            coarse_map[2], coarse_elev, win=win, fallback_threshold=0.02)
        central = coarse_map[:, win // 2:-(win // 2), win // 2:-(win // 2)]
        H_src, W_src = temp_baseline.shape
        grid = torch.stack([(v + 0.5) * 2 / W_src - 1, (u + 0.5) * 2 / H_src - 1], dim=-1)
        features = torch.cat([temp_baseline[None], beta[None], central], dim=0)
        feats_up = grid_sample_bilinear(features, grid)
        temp_realistic = feats_up[0] + feats_up[1] * torch.clamp(elev, min=0.0)
        return torch.stack([temp_realistic, feats_up[5], feats_up[6], feats_up[7],
                            feats_up[1]])

    def prefetch(self, queries, with_climate: bool = True) -> None:
        """Plan and generate every stage window the `queries` ((i1, j1, i2,
        j2) boxes) need, in one pass over all three stage roots."""
        scale = self.latent_compression
        res_list, lat_list, coarse_list = [], [], []
        for (i1, j1, i2, j2) in queries:
            res_ranges, lat_ranges, _, _ = self._elev_ranges(i1, j1, i2, j2, scale)
            res_list.append(res_ranges)
            lat_list.append(lat_ranges)
            if with_climate:
                coarse_list.append(self._climate_ranges(i1, j1, i2, j2, scale))
        reqs = [(self.residual, res_list), (self.latents, lat_list)]
        if coarse_list:
            reqs.append((self.coarse, coarse_list))
        ensure_regions_multi(reqs)

    def get(self, i1, j1, i2, j2, with_climate: bool = True,
            pack_wire: bool = False) -> dict:
        """Terrain for a bounding box: elev (H, W) meters [+ climate (5, H, W)].

        pack_wire=True packs the serving wire formats on the device before the
        fetch: elevation floor + clip to int16, climate to float16."""
        scale = self.latent_compression
        with torch.no_grad():
            self._timed("prefetch", lambda: self.prefetch([(i1, j1, i2, j2)], with_climate))
            elev = self._timed("compose_elev", lambda: self._compute_elev(
                i1, j1, i2, j2, scale))
            climate = (self._timed("compose_climate", lambda: self._compute_climate(
                i1, j1, i2, j2, elev, scale)) if with_climate else None)
            if pack_wire:
                elev = torch.clamp(torch.floor(elev), -32768, 32767).to(torch.int16)
                climate = climate.half() if climate is not None else None
            out = self._timed("fetch", lambda: {
                "elev": elev.cpu().numpy(),
                "climate": climate.cpu().numpy() if climate is not None else None})
        return out
