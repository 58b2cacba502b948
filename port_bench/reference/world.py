"""Direct evaluator of the 90 m world: the three stages and the output
composition, window by window, in float32.

The semantics the port's tiled runtime implements, written out plainly: a
stage tensor's value over a region is the sum of the outputs of every window
that overlaps it (values times a linear weight window, plus that weight as
the last channel), summed in sorted window order; a window's inputs are its
parents' regions at the window's argument boxes.  The stage bodies follow
the port's ``pipeline/world.py`` (coarse: 20-step DPM-Solver++ on the
synthetic map mixed with noise; latent: the T=2 consistency init and one
intermediate step; decoder: one consistency step on the x8-upsampled
latents), the composition its ``_elev_core`` / ``_climate_core`` and the
wire packing.  Windows are cached in a dict; nothing is padded to buckets.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from .image import (grid_sample_bilinear, laplacian_decode, laplacian_denoise,
                    linear_weight_window, local_baseline_temperature, signed_square,
                    upsample_nearest)
from .noise import threefry_noise_batch
from .sampler import EDMSchedulerConfig, compute_sigmas, sample_dpm, trigflow_precondition_noise
from .synthetic_map import make_synthetic_map_factory
from .unet import mp_concat
from .window import TensorWindow

SCHED = EDMSchedulerConfig(sigma_min=0.002, sigma_max=80, sigma_data=0.5)
SD = SCHED.sigma_data
COND_INPUT_MEAN = np.array([14.99, 11.65, 15.87, 619.26, 833.12, 69.40, 0.66], np.float32)
COND_INPUT_STD = np.array([21.72, 21.78, 10.40, 452.29, 738.09, 34.59, 0.47], np.float32)
LOWFREQ_MEAN, LOWFREQ_STD = -31.4, 38.6
COARSE_TILE, COARSE_STRIDE = 64, 48
LATENT_TILE, LATENT_STRIDE = 64, 32
# windows evaluated together, per stage
CHUNK = {"coarse": 8, "init": 16, "step": 16, "decoder": 2}


def elev_ranges(i1, j1, i2, j2, scale):
    """(residual ranges, latent ranges, pi1, pj1) an elevation query reads."""
    pad = (5 + 1) * scale
    pi1, pj1 = ((i1 - pad) // scale) * scale, ((j1 - pad) // scale) * scale
    pi2 = pi1 + -(-(i2 - i1 + 2 * pad + scale - 1) // scale) * scale
    pj2 = pj1 + -(-(j2 - j1 + 2 * pad + scale - 1) // scale) * scale
    return ([(0, 2), (pi1, pi2), (pj1, pj2)],
            [(0, 6), (pi1 // scale, pi2 // scale), (pj1 // scale, pj2 // scale)], pi1, pj1)


def climate_ranges(i1, j1, i2, j2, scale):
    """Coarse ranges a climate query reads."""
    s = 32 * scale
    ci1, cj1 = i1 // s, j1 // s
    ci2, cj2 = ci1 + -(-(i2 - i1 + s - 1) // s), cj1 + -(-(j2 - j1 + s - 1) // s)
    return [(0, 7), (ci1 - 8, ci2 + 8), (cj1 - 8, cj2 + 8)]


class RefWorld:
    """The world of ``seed`` over the models ``coarse``, ``base`` and
    ``decoder`` (``unet.UNet``), with the world settings ``cfg`` (the keys of
    the port's ``WorldPipeline.get_config``)."""

    def __init__(self, coarse, base, decoder, seed: int, cfg: dict, device):
        if cfg.get("T", 2) != 2 or cfg.get("onestep_latent", False):
            raise ValueError(
                "RefWorld evaluates the T=2 world with its intermediate step, the world kind "
                "t2 (port_bench/worlds/t2.py); a T=1, one-step or guided world is a "
                "world kind of its own, port_bench/worlds/<kind>.py, named by the "
                "configuration's world_kind, whose reference() builds its plain reference")
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        self.models = {"coarse": coarse, "base": base, "decoder": decoder}
        self.seed = int(seed) & 0xFFFFFFFFFFFFFFFF
        self.cfg = cfg
        self.device = torch.device(device)
        self.lc = cfg["latent_compression"]
        dt, ds = cfg["decoder_tile_size"], cfg["decoder_tile_stride"]
        self.win = {
            "coarse": TensorWindow((7, COARSE_TILE, COARSE_TILE), (7, COARSE_STRIDE, COARSE_STRIDE)),
            "init": TensorWindow((6, LATENT_TILE, LATENT_TILE), (6, LATENT_STRIDE, LATENT_STRIDE)),
            "step": TensorWindow((6, LATENT_TILE, LATENT_TILE), (6, LATENT_STRIDE, LATENT_STRIDE)),
            "decoder": TensorWindow((2, dt, dt), (2, ds, ds)),
        }
        coarse_arg = TensorWindow((7, 4, 4), (7, 1, 1), offset=(0, -1, -1))
        self.parents = {  # stage -> ((parent, argument window), ...)
            "coarse": (),
            "init": (("coarse", coarse_arg),),
            "step": (("init", self.win["init"]), ("coarse", coarse_arg)),
            "decoder": (("step", TensorWindow((6, dt // self.lc, dt // self.lc),
                                              (6, ds // self.lc, ds // self.lc))),),
        }
        self.cache = {k: {} for k in self.win}
        self.evaluated = {k: 0 for k in self.win}
        self.seconds = {k: 0.0 for k in self.win}
        self.smap = make_synthetic_map_factory(cfg["frequency_mult"], self.seed,
                                               cfg["drop_water_pct"])
        self.sigma0 = float(compute_sigmas(SCHED, 20)[0])

    def _t(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a, np.float32), device=self.device)

    def _noise(self, seed, y0s, x0s, h, w, channels, tile):
        return threefry_noise_batch(seed, y0s, x0s, h, w, channels, tile, tile, self.device)

    # -- tensors -----------------------------------------------------------
    def region(self, name: str, ranges) -> torch.Tensor:
        """The stage tensor's value over ``ranges`` (the summed windows)."""
        win = self.win[name]
        idxs = sorted(win.windows_overlapping(ranges))
        self.ensure(name, idxs)
        out = torch.zeros([b - a for a, b in ranges], device=self.device)
        for idx in idxs:
            box = win.box(idx)
            lo = [max(a, b0) for (a, _), (b0, _) in zip(ranges, box)]
            hi = [min(b, b1) for (_, b), (_, b1) in zip(ranges, box)]
            if any(l >= h for l, h in zip(lo, hi)):
                continue
            dst = tuple(slice(l - a, h - a) for l, h, (a, _) in zip(lo, hi, ranges))
            src = tuple(slice(l - b0, h - b0) for l, h, (b0, _) in zip(lo, hi, box))
            out[dst] += self.cache[name][idx][src]
        return out

    def ensure(self, name: str, idxs):
        missing = [i for i in dict.fromkeys(map(tuple, idxs)) if i not in self.cache[name]]
        if not missing:
            return
        for parent, arg_win in self.parents[name]:
            need = {w for i in missing
                    for w in self.win[parent].windows_overlapping(arg_win.box(i))}
            self.ensure(parent, sorted(need))
        t0 = time.perf_counter()
        for k in range(0, len(missing), CHUNK[name]):
            chunk = missing[k:k + CHUNK[name]]
            args = [torch.stack([self.region(p, aw.box(i)) for i in chunk])
                    for p, aw in self.parents[name]]
            out = getattr(self, f"_{name}")(np.asarray(chunk, np.int64), *args)
            for i, o in zip(chunk, out):
                self.cache[name][i] = o
            self.evaluated[name] += len(chunk)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.seconds[name] += time.perf_counter() - t0

    # -- stages --------------------------------------------------------------
    def _coarse(self, ctxs):
        kw = self.cfg
        means = np.asarray(kw["coarse_means"], np.float32)
        stds = np.asarray(kw["coarse_stds"], np.float32)
        cm, cs = means[[0, 2, 3, 4, 5]], stds[[0, 2, 3, 4, 5]]
        t_cond = np.arctan(np.asarray(kw["cond_snr"], np.float32))
        B, T = len(ctxs), COARSE_TILE
        i1s = [int(i) * COARSE_STRIDE for i in ctxs[:, 1]]
        j1s = [int(j) * COARSE_STRIDE for j in ctxs[:, 2]]
        cond = self._t(np.stack([(self.smap(i, j, i + T, j + T) - cm[:, None, None])
                                 / cs[:, None, None] for i, j in zip(i1s, j1s)]))
        tc = self._t(t_cond).reshape(1, -1, 1, 1)
        cond_img = torch.cos(tc) * cond + torch.sin(tc) * self._noise(self.seed, i1s, j1s, T, T, 5, T)
        x = self._noise(self.seed + 1, i1s, j1s, T, T, 6, T) * self.sigma0
        scalars = [torch.full((B,), float(v), device=self.device)
                   for v in np.log(np.tan(t_cond) / 8.0)]
        model = self.models["coarse"]

        def model_fn(scaled, sigma):
            label = float(trigflow_precondition_noise(sigma, SD))
            x_in = torch.cat([scaled, cond_img], dim=1).permute(0, 2, 3, 1)
            out = model(x_in, torch.full((B,), label, device=self.device), scalars)
            return out.permute(0, 3, 1, 2)

        s = sample_dpm(model_fn, x, SCHED, 20) / SD
        s = s * self._t(stds).reshape(1, -1, 1, 1) + self._t(means).reshape(1, -1, 1, 1)
        s = torch.cat([s[:, :1], s[:, :1] - s[:, 1:2], s[:, 2:]], dim=1)
        return self._weighted(s, T)

    def _weighted(self, sample, tile):
        wwin = self._t(linear_weight_window(tile))
        return torch.cat([sample * wwin, wwin.expand(len(sample), 1, tile, tile)], dim=1)

    def _cond(self, coarse):
        B = coarse.shape[0]
        vals = coarse[:, :-1] / coarse[:, -1:]
        cond = torch.cat([vals, torch.ones((B, 1, 4, 4), device=self.device)], dim=1)
        cond = (cond - self._t(COND_INPUT_MEAN).reshape(1, 7, 1, 1)) / self._t(
            COND_INPUT_STD).reshape(1, 7, 1, 1)
        cond = torch.nan_to_num(cond, nan=float(COND_INPUT_MEAN[0]))
        hist = self._t(self.cfg["histogram_raw"]).expand(B, -1)
        level = torch.full((B, 1), (0.0 - 0.5) * np.sqrt(12), device=self.device)
        return mp_concat([cond[:, 0].reshape(B, -1), cond[:, 1].reshape(B, -1),
                          cond[:, 2:6, 1:3, 1:3].mean(dim=(2, 3)), cond[:, 6].reshape(B, -1),
                          hist, level], dim=1)

    def _latent(self, ctxs, t_value, seed_offset, prev, coarse):
        B, T = len(ctxs), LATENT_TILE
        t = torch.tensor(t_value, dtype=torch.float32, device=self.device)
        z = self._noise(self.seed + seed_offset, ctxs[:, 1] * LATENT_STRIDE,
                        ctxs[:, 2] * LATENT_STRIDE, T, T, 5, T)
        x_t = torch.cos(t) * prev + torch.sin(t) * (z * SD)
        pred = -self.models["base"]((x_t / SD).permute(0, 2, 3, 1), t.expand(B),
                                    [self._cond(coarse)]).permute(0, 3, 1, 2)
        return self._weighted((torch.cos(t) * x_t - torch.sin(t) * SD * pred) / SD, T)

    def _init(self, ctxs, coarse):
        prev = torch.zeros((len(ctxs), 5, LATENT_TILE, LATENT_TILE), device=self.device)
        return self._latent(ctxs, float(np.arctan(self.sigma0 / SD)), 5819, prev, coarse)

    def _step(self, ctxs, init, coarse):
        prev = init[:, :-1] / init[:, -1:] * SD
        return self._latent(ctxs, float(np.arctan(0.35 / 0.5)), 5820, prev, coarse)

    def _decoder(self, ctxs, latents):
        B = len(ctxs)
        T, S = self.cfg["decoder_tile_size"], self.cfg["decoder_tile_stride"]
        up = upsample_nearest((latents[:, :-1] / latents[:, -1:])[:, :4], self.lc)
        t = torch.tensor(float(np.arctan(self.sigma0 / SD)), dtype=torch.float32,
                         device=self.device)
        z = self._noise(self.seed + 15819, ctxs[:, 1] * S, ctxs[:, 2] * S, T, T, 1, T)
        x_t = torch.sin(t) * (z * SD)  # the step starts from a zero sample
        x_in = torch.cat([x_t / SD, up], dim=1).permute(0, 2, 3, 1)
        pred = -self.models["decoder"](x_in, t.expand(B), []).permute(0, 3, 1, 2)
        return self._weighted((torch.cos(t) * x_t - torch.sin(t) * SD * pred) / SD, T)

    # -- output composition ----------------------------------------------------
    def tile(self, i1, j1, i2, j2) -> dict:
        """Everything a served tile is compared on: the stage regions it read
        (blended values, weight channel divided out) and their composition
        (``compose``)."""
        lc = self.lc
        res_r, lat_r, _, _ = elev_ranges(i1, j1, i2, j2, lc)
        residual, latents = self.region("decoder", res_r), self.region("step", lat_r)
        coarse = self.region("coarse", climate_ranges(i1, j1, i2, j2, lc))
        out = {"residual": residual[0] / residual[1], "latents": latents[:-1] / latents[-1:],
               "coarse": coarse[:-1] / coarse[-1:]}
        out.update(compose(out["residual"], out["latents"], out["coarse"], (i1, j1, i2, j2),
                           self.cfg))
        return out


def compose(residual, latents, coarse, box, cfg, q=None) -> dict:
    """The output composition of one tile from its stage regions (blended
    values): the Laplacian denoise and decode with the signed square, the
    windowed temperature regression and the grid-sample, and the wire
    packing (int16 floor of the elevation, float16 climate).  ``q`` rounds
    the operands of its matmuls, convolutions, window sums and bilinear
    sums (the control)."""
    q = q or (lambda x: x)
    i1, j1, i2, j2 = box
    h, w, lc = i2 - i1, j2 - j1, cfg["latent_compression"]
    _, _, pi1, pj1 = elev_ranges(i1, j1, i2, j2, lc)
    residual_p = residual * cfg["residual_std"] + cfg["residual_mean"]
    lowfreq_p = latents[4] * LOWFREQ_STD + LOWFREQ_MEAN
    elev_p = laplacian_decode(*laplacian_denoise(residual_p[None], lowfreq_p[None], sigma=5,
                                                 q=q), q=q)
    elev = signed_square(elev_p[0, i1 - pi1:i1 - pi1 + h, j1 - pj1:j1 - pj1 + w])
    S = 32 * lc
    climate = _climate(coarse, elev, i1 - (i1 // S) * S, j1 - (j1 // S) * S, S, q)
    return {"elev": elev, "climate": climate,
            "wire_elev": torch.clamp(torch.floor(elev), -32768, 32767).to(torch.int16),
            "wire_climate": climate[:4].half().float()}


def _climate(cmap, elev, di, dj, S, q):
    win = 15
    h, w = elev.shape
    celev = torch.sign(cmap[0]) * torch.square(torch.clamp(cmap[0], min=0.0))
    base, beta = local_baseline_temperature(cmap[2], celev, win=win, fallback_threshold=0.02,
                                            q=q)
    central = cmap[:, win // 2:-(win // 2), win // 2:-(win // 2)]
    H, W = base.shape
    f32 = dict(device=elev.device, dtype=torch.float32)
    ii = (di + torch.arange(h, **f32))[:, None]
    jj = (dj + torch.arange(w, **f32))[None, :]
    u = ((ii + 0.5) / S + 0.5).expand(h, w)
    v = ((jj + 0.5) / S + 0.5).expand(h, w)
    grid = torch.stack([(v + 0.5) * 2 / W - 1, (u + 0.5) * 2 / H - 1], dim=-1)
    feats = grid_sample_bilinear(torch.cat([base[None], beta[None], central]), grid, q)
    temp = feats[0] + feats[1] * torch.clamp(elev, min=0.0)
    return torch.stack([temp, feats[5], feats[6], feats[7], feats[1]])
