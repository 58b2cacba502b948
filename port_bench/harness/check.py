"""``correct``: the served tiles of a run against the plain reference.

After the window, a sample of the tiles the run served last (drawn from the
seed) is read on the program's side: the wire payload each client received
(int16 elevation, float32 climate from the float16 wire), the world's float
elevation and climate for the same box through ``WorldPipeline.get``, and
the three stage regions the tile reads (``read_device``: the coarse region,
the latent region after both T=2 phases, the decoder residual).  Then the
program is freed and ``reference.world.RefWorld`` evaluates the same tiles
from the same weights, seed and boxes.

The numbers, each the largest reading over the sample:
- a gap (``GAPS``): per channel, max |program - reference| over the
  reference's RMS, the worst channel taken; climate on the four channels
  the wire serves (the fifth, the local lapse rate, is a clamped regression
  with thresholds that a rounding flips);
- a flip share (``FLIPS``): the share of the wire's values (whole metres,
  float16 climate) that differ from the reference's packing: a rounding
  flips a few, a lower precision many;
- ``elev_sqrt``: the elevation's gap on a scale the world fixes, not the
  tile: max |program - reference| in the signed square root the stages
  compose it in, over the latents' elevation scale.  A tile near sea level
  has a small RMS in metres, and the ``elev`` gap over it swings from seed
  to seed; this one does not;
- the composition checked by itself (``COMPOSE``, ``COMPOSE_FLIPS``): the
  reference composes the program's own stage regions, and the program's
  float elevation and climate and its wire are held against that.
A value that is not finite reads infinite.  Each cell compares the numbers
its ``limits`` name: those that separate the program from the control.
"""
from __future__ import annotations

import sys

import numpy as np
import torch

from reference.unet import QUANTIZERS, UNet
from reference.world import LOWFREQ_STD, RefWorld, climate_ranges, compose, elev_ranges

GAPS = ("coarse", "latents", "residual", "elev", "climate")
FLIPS = {"wire_elev_flips": "wire_elev", "wire_climate_flips": "wire_climate"}


def gap(p: torch.Tensor, r: torch.Tensor) -> float:
    p, r = p.double(), r.double()
    if p.dim() == 2:
        p, r = p[None], r[None]
    if p.shape != r.shape:
        return float("inf")
    d = (p - r).abs().flatten(1).amax(dim=1)
    rms = r.pow(2).flatten(1).mean(dim=1).sqrt().clamp(min=1e-12)
    g = float((d / rms).max())
    return g if np.isfinite(g) else float("inf")


def signed_sqrt(x: torch.Tensor) -> torch.Tensor:
    """The inverse of the composition's signed square: metres back to the
    scale the stages compose the elevation in."""
    return torch.sign(x) * torch.sqrt(torch.abs(x))


def scaled_gap(p: torch.Tensor, r: torch.Tensor, scale) -> float:
    """max over channels of max |p - r| over the channel's fixed ``scale``."""
    p, r = p.double(), r.double()
    if p.dim() == 2:
        p, r = p[None], r[None]
    if p.shape != r.shape:
        return float("inf")
    d = (p - r).abs().flatten(1).amax(dim=1)
    g = float((d / torch.as_tensor(scale, dtype=torch.float64)).max())
    return g if np.isfinite(g) else float("inf")


def elev_sqrt_gap(p: torch.Tensor, r: torch.Tensor) -> float:
    return scaled_gap(signed_sqrt(p), signed_sqrt(r), [LOWFREQ_STD])


def sample_boxes(records, seed: int, n: int, last: int) -> list:
    """``n`` of the ``last`` tiles served, drawn from the seed.  Their stage
    windows are still in the atlases when the check reads them back, so the
    program's state it reads is the one that served them: a window evicted
    and computed again in another batch can round otherwise (in bf16 it
    does)."""
    done = sorted((r for r in records if r.ok), key=lambda r: r.t1)[-last:]
    rng = np.random.default_rng(seed)
    pick = rng.choice(len(done), size=min(n, len(done)), replace=False)
    return [done[k] for k in sorted(pick)]


def program_tiles(world, records) -> list:
    """The program's side of each sampled record, on the host."""
    out = []
    lc = world.latent_compression
    with torch.no_grad():
        for rec in records:
            i1, j1, i2, j2 = rec.box
            h, w = i2 - i1, j2 - j1
            wire_elev = np.frombuffer(rec.body[:h * w * 2], "<i2").reshape(h, w)
            wire_clim = np.frombuffer(rec.body[h * w * 2:], "<f4").reshape(h, w, 4)
            res_r, lat_r, _, _ = elev_ranges(i1, j1, i2, j2, lc)
            residual = world.residual.read_device(res_r)
            latents = world.latents.read_device(lat_r)
            coarse = world.coarse.read_device(climate_ranges(i1, j1, i2, j2, lc))
            full = world.get(i1, j1, i2, j2, with_climate=True, pack_wire=False)
            out.append({
                "residual": (residual[0] / residual[1]).cpu(),
                "latents": (latents[:-1] / latents[-1:]).cpu(),
                "coarse": (coarse[:-1] / coarse[-1:]).cpu(),
                "elev": torch.from_numpy(np.asarray(full["elev"], np.float32)),
                "climate": torch.from_numpy(np.asarray(full["climate"][:4], np.float32)),
                "wire_elev": torch.from_numpy(wire_elev.astype(np.float32)),
                "wire_climate": torch.from_numpy(np.ascontiguousarray(
                    wire_clim.transpose(2, 0, 1))),
            })
    return out


def reference_tiles(model_cfgs, states, world_cfg, world_seed, boxes, device,
                    quant: str = "none") -> list:
    """The reference's side of each box (``quant`` != "none": the control)."""
    models = {}
    for s, cfg in model_cfgs.items():
        m = UNet(cfg, device=device, quant=quant)
        m.load_state_dict(states[s])
        models[s] = m.eval()
    ref = RefWorld(models["coarse"], models["base"], models["decoder"], world_seed,
                   world_cfg, device)
    out = []
    with torch.no_grad():
        for box in boxes:
            t = ref.tile(*box)
            t["wire_elev"] = t["wire_elev"].float()
            t["climate"] = t["climate"][:4]
            out.append({k: v.cpu() for k, v in t.items()})
    print(f"[reference] {quant}: windows {ref.evaluated}, seconds "
          f"{ {k: round(v, 3) for k, v in ref.seconds.items()} }", file=sys.stderr, flush=True)
    return out


def flips(p: torch.Tensor, r: torch.Tensor) -> float:
    """Share of the wire's values (int16 metres, float16 climate) that
    differ from the reference's packing of the same tile."""
    return float((p != r).double().mean()) if p.shape == r.shape else float("inf")


COMPOSE = {"compose_elev": "elev", "compose_climate": "climate"}
COMPOSE_FLIPS = {"compose_wire_elev_flips": "wire_elev",
                 "compose_wire_climate_flips": "wire_climate"}


def composed_from_program(got: list, boxes, world_cfg, device, quant: str = "none") -> list:
    """The reference's composition of each sampled tile from the program's
    own stage regions: the composition stage checked by itself, in float32
    in both types (``quant`` rounds its matmul and conv operands: the
    control of a float32 stage is TF32)."""
    q = QUANTIZERS[quant]
    out = []
    with torch.no_grad():
        for g, box in zip(got, boxes):
            c = compose(g["residual"].to(device), g["latents"].to(device),
                        g["coarse"].to(device), box, world_cfg, q)
            out.append({"elev": c["elev"].cpu(), "climate": c["climate"][:4].cpu(),
                        "wire_elev": c["wire_elev"].float().cpu(),
                        "wire_climate": c["wire_climate"].cpu()})
    return out


def compare_compose(got: list, composed: list) -> dict:
    out = {k: max(gap(g[q], c[q]) for g, c in zip(got, composed)) for k, q in COMPOSE.items()}
    out.update({k: max(flips(g[q], c[q]) for g, c in zip(got, composed))
                for k, q in COMPOSE_FLIPS.items()})
    return out


def compare(got: list, want: list) -> dict:
    """{number: its largest reading over the sample}: each quantity's gap,
    and the share of wire values that differ."""
    out = {k: max(gap(g[k], w[k]) for g, w in zip(got, want)) for k in GAPS}
    out.update({k: max(flips(g[q], w[q]) for g, w in zip(got, want)) for k, q in FLIPS.items()})
    out["elev_sqrt"] = max(elev_sqrt_gap(g["elev"], w["elev"]) for g, w in zip(got, want))
    return out


def judge(readings: dict, limits: dict) -> bool:
    return all(readings[k] <= limits[k] for k in limits)
