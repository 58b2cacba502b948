"""Hyperparameter sweeps over EMA length / guidance scale / the consistency
step (counterpart of ``terrain_diffusion_tpu.training.sweeps.sweep``):

- **TPE sampler** (``TPESampler``): quasi-random startup trials, then
  candidates scored by the good/bad kernel-density ratio per dimension
  (Optuna's univariate TPE shape: n_startup_trials, n_ei_candidates,
  prior_weight mixing a uniform prior).
- **Probability pruning**: objectives may report intermediate
  (mean, std) estimates; a trial stops early when the probability that it
  beats ANY completed trial drops below ``prune_probability_threshold``.
  Pruned trials keep their last estimate as their value.
- **Storage**: JSON-lines (resumable) + Optuna-JSON import/export
  (``import_optuna_trials`` / ``export_optuna_trials``).

These are host numpy, copied from the JAX package so that the same seed
gives the same suggestions, trials and files bit for bit.  The objectives
run on ``--device`` (the card by default): the autoencoder mode scores
EMA weights synthesized from the PostHocEMA snapshots by the VAE's
validation loss; the KID modes save the synthesized weights and run
``evaluation/stage_eval.run_stage_eval`` on them.

    python -m terrain_diffusion_tpu_torch.training.sweeps.sweep <checkpoint_dir> \
        --mode autoencoder --h5-file dataset.h5 --storage trials.jsonl
"""
from __future__ import annotations

import json
import math
import os

import click
import numpy as np

def halton(index: int, base: int) -> float:
    f, r = 1.0, 0.0
    i = index + 1
    while i > 0:
        f /= base
        r += f * (i % base)
        i //= base
    return r


class SweepSpace:
    def __init__(self, spec: dict):
        # spec: name -> (lo, hi, log?)
        self.spec = spec
        self.names = list(spec)

    def sample_quasirandom(self, idx: int) -> dict:
        primes = [2, 3, 5, 7, 11, 13][: len(self.names)]
        out = {}
        for name, p in zip(self.names, primes):
            lo, hi, log = self.spec[name]
            u = halton(idx, p)
            if log:
                out[name] = float(np.exp(np.log(lo) + u * (np.log(hi) - np.log(lo))))
            else:
                out[name] = float(lo + u * (hi - lo))
        return out


class TPESampler:
    """Univariate Tree-structured Parzen Estimator (Optuna-shaped knobs)."""

    def __init__(self, space: SweepSpace, n_startup_trials: int = 7,
                 n_ei_candidates: int = 24, gamma: float = 0.25,
                 prior_weight: float = 1.0, seed: int = 0):
        self.space = space
        self.n_startup = int(n_startup_trials)
        self.n_candidates = int(n_ei_candidates)
        self.gamma = float(gamma)
        self.prior_weight = float(prior_weight)
        self.rng = np.random.default_rng(seed)

    def _to_unit(self, name, v):
        lo, hi, log = self.space.spec[name]
        if log:
            return (np.log(v) - np.log(lo)) / (np.log(hi) - np.log(lo))
        return (v - lo) / (hi - lo)

    def _from_unit(self, name, u):
        lo, hi, log = self.space.spec[name]
        u = float(np.clip(u, 0.0, 1.0))
        if log:
            return float(np.exp(np.log(lo) + u * (np.log(hi) - np.log(lo))))
        return float(lo + u * (hi - lo))

    @staticmethod
    def _kde_logpdf(x, centers, bw, prior_weight):
        """Gaussian KDE on [0,1] mixed with a uniform prior component."""
        n = len(centers)
        z = (x[:, None] - centers[None, :]) / bw
        comps = np.exp(-0.5 * z * z) / (bw * np.sqrt(2 * np.pi))
        dens = (comps.sum(axis=1) + prior_weight) / (n + prior_weight)
        return np.log(np.maximum(dens, 1e-300))

    def suggest(self, trials) -> dict:
        done = [t for t in trials if t.get("value") is not None]
        i = len(trials)
        if len(done) < self.n_startup:
            return self.space.sample_quasirandom(i)
        done = sorted(done, key=lambda t: t["value"])
        n_good = max(1, int(np.ceil(self.gamma * len(done))))
        good, bad = done[:n_good], done[n_good:] or done[-1:]

        out = {}
        for name in self.space.names:
            g = np.array([self._to_unit(name, t["params"][name]) for t in good])
            b = np.array([self._to_unit(name, t["params"][name]) for t in bad])
            # magic-clip bandwidth floor (Optuna-style): with few good
            # points the kernels must stay wide or the sampler locks onto
            # the startup incumbent and never explores
            floor_g = max(0.05, 1.0 / (1.0 + len(g)))
            floor_b = max(0.05, 1.0 / (1.0 + len(b)))
            bw_g = max(1.06 * (g.std() + 1e-3) * len(g) ** (-0.2), floor_g)
            bw_b = max(1.06 * (b.std() + 1e-3) * len(b) ** (-0.2), floor_b)
            # candidates drawn from the good model INCLUDING its uniform
            # prior component (Optuna mixes the prior into l(x) the same
            # way) — the prior draws keep exploration alive
            p_prior = self.prior_weight / (len(g) + self.prior_weight)
            pick = self.rng.integers(0, len(g), self.n_candidates)
            cand = g[pick] + self.rng.normal(size=self.n_candidates) * bw_g
            from_prior = self.rng.uniform(size=self.n_candidates) < p_prior
            cand[from_prior] = self.rng.uniform(0, 1, int(from_prior.sum()))
            # reflect at the boundaries instead of clipping (clipping piles
            # candidate mass on the edges and can lock the sampler there)
            cand = np.abs(cand)
            cand = np.where(cand > 1.0, 2.0 - cand, cand)
            cand = np.clip(cand, 0.0, 1.0)
            score = (self._kde_logpdf(cand, g, bw_g, self.prior_weight)
                     - self._kde_logpdf(cand, b, bw_b, self.prior_weight))
            out[name] = self._from_unit(name, cand[int(np.argmax(score))])
        return out


def prune_probability(cur_mean: float, cur_std: float, trials,
                      threshold: float) -> bool:
    """Reference pruning rule (`sweep_diffusion_base.py:99-117`): prune when
    P(current < other) < threshold for ANY COMPLETED trial with a std.
    Pruned trials carry low-budget noisy estimates and must not become
    incumbents (the reference queries optuna states=(COMPLETE,) only)."""
    for t in trials:
        if t.get("pruned"):
            continue
        if t.get("value") is None or t.get("value_std") is None:
            continue
        denom = math.sqrt(cur_std**2 + float(t["value_std"]) ** 2)
        if denom <= 0:
            continue
        z = -(cur_mean - float(t["value"])) / denom
        p_cur_less = 0.5 * (1.0 + math.erf(z / math.sqrt(2.0)))
        if p_cur_less < threshold:
            return True
    return False


def import_optuna_trials(path: str) -> list:
    """Read an Optuna trials JSON export (list of dicts with 'params',
    'value'/'values', optional 'user_attrs.kid_std', 'state')."""
    with open(path) as f:
        raw = json.load(f)
    out = []
    for i, t in enumerate(raw):
        value = t.get("value")
        if value is None and t.get("values"):
            value = t["values"][0]
        if value is None:
            continue
        out.append({
            "index": i, "params": t["params"], "value": float(value),
            "value_std": (t.get("user_attrs") or {}).get("kid_std"),
            "pruned": str(t.get("state", "")).upper().endswith("PRUNED"),
        })
    return out


def export_optuna_trials(trials: list, path: str) -> None:
    """Write trials in Optuna's JSON export shape."""
    raw = []
    for t in trials:
        raw.append({
            "number": t.get("index", 0), "params": t["params"],
            "value": t["value"],
            "state": "PRUNED" if t.get("pruned") else "COMPLETE",
            "user_attrs": ({"kid_std": t["value_std"]}
                           if t.get("value_std") is not None else {}),
        })
    with open(path, "w") as f:
        json.dump(raw, f, indent=1)


def run_sweep(objective, space: SweepSpace, n_trials: int = 40,
              storage: str | None = None, seed: int = 0,
              sampler: TPESampler | None = None,
              prune_probability_threshold: float | None = None,
              n_startup_trials: int = 7, n_ei_candidates: int = 24,
              prior_weight: float = 1.0) -> dict:
    """Minimize `objective`; returns the best trial.

    Objective protocols:
    - ``objective(params) -> float``
    - ``objective(params, report) -> float | (mean, std)`` — call
      ``report(mean, std) -> bool`` with intermediate estimates; a True
      return means "pruned: stop and return the current estimate".
    """
    trials = []
    if storage and os.path.exists(storage):
        with open(storage) as f:
            trials = [json.loads(line) for line in f if line.strip()]
        print(f"resumed {len(trials)} trials from {storage}")
    if sampler is None:
        sampler = TPESampler(space, n_startup_trials=n_startup_trials,
                             n_ei_candidates=n_ei_candidates,
                             prior_weight=prior_weight, seed=seed)

    def record(t):
        trials.append(t)
        if storage:
            with open(storage, "a") as f:
                f.write(json.dumps(t) + "\n")
        return t

    import inspect

    takes_report = len(inspect.signature(objective).parameters) >= 2

    while len(trials) < n_trials:
        i = len(trials)
        params = sampler.suggest(trials)
        pruned = {"flag": False}

        def report(mean, std):
            if prune_probability_threshold is None:
                return False
            if prune_probability(float(mean), float(std), trials,
                                 prune_probability_threshold):
                pruned["flag"] = True
                return True
            return False

        result = objective(params, report) if takes_report else objective(params)
        if isinstance(result, tuple):
            value, value_std = float(result[0]), float(result[1])
        else:
            value, value_std = float(result), None
        t = record({"params": params, "value": value, "value_std": value_std,
                    "pruned": pruned["flag"], "index": i})
        tag = " (pruned)" if pruned["flag"] else ""
        print(f"trial {i}: value={value:.5f}{tag} params={params}")
    finished = [t for t in trials if not t.get("pruned")]
    # pruned trials carry quarter-budget noisy estimates — never winners
    # (reference: Optuna best_trial queries states=(COMPLETE,) only)
    best = min(finished or trials, key=lambda t: t["value"])
    print(f"best: value={best['value']:.5f} params={best['params']}")
    return best


def autoencoder_items(h5_file: str, n_images: int, seed: int) -> list:
    """The validation items the autoencoder objective scores: max(n_images,
    8) draws of ``H5AutoencoderDataset`` (crop 64, the val split)."""
    from terrain_diffusion_tpu_torch.training.datasets import H5AutoencoderDataset

    ds = H5AutoencoderDataset(
        h5_file=h5_file, crop_size=64, pct_land_ranges=[[0, 1]],
        subset_resolutions=[90], split="val", eval_dataset=True)
    rng = np.random.default_rng(seed)
    return [ds[int(rng.integers(1 << 31))] for _ in range(max(n_images, 8))]


def autoencoder_objective(model, phema_dir: str, items: list, seed: int):
    """EMA sigma_rel vs validation reconstruction loss (MAE + KL) of
    ``items`` in batches of 8, the reference's sweep_autoencoder objective:
    ``objective(params, report) -> (mean, std)``.  Each trial loads the EMA
    weights synthesized for ``params["ema_sigma"]`` into ``model`` and runs
    it on its device under ``torch.no_grad()``; batch k draws its posterior
    from the k-th split of ``key_from_seed(seed)``."""
    import torch

    from terrain_diffusion_tpu_torch.ops.noise_field import key_from_seed, split
    from terrain_diffusion_tpu_torch.training.diffusion_core import autoencoder_loss
    from terrain_diffusion_tpu_torch.training.phema import PostHocEMA

    dev = next(model.parameters()).device

    def objective(params, report):
        model.load_state_dict(PostHocEMA.synthesize_from_folder(
            phema_dir, params["ema_sigma"]), strict=False)
        key = key_from_seed(seed)
        losses = []
        for i in range(0, len(items), 8):
            batch = {"image": torch.as_tensor(np.stack(
                [it["image"] for it in items[i:i + 8]]), device=dev)}
            key, sub = split(key)
            with torch.no_grad():
                loss, _aux = autoencoder_loss(model, batch, sub)
            losses.append(float(loss))
            mid = float(np.mean(losses))
            if i and report(mid, max(float(np.std(losses)), 1e-8)):
                return mid, max(float(np.std(losses)), 1e-8)
        return (float(np.mean(losses)),
                max(float(np.std(losses)), 1e-8))

    return objective


def _export_trials(storage, optuna_export):
    if optuna_export and storage and os.path.exists(storage):
        with open(storage) as f:
            all_trials = [json.loads(line) for line in f if line.strip()]
        export_optuna_trials(all_trials, optuna_export)


def _phema_dir(checkpoint_dir: str) -> str:
    """Training writes phema/ as a SIBLING of latest_checkpoint (``ema_for``
    in trainers/base.py); accept either layout, as save_model does."""
    phema_dir = os.path.join(checkpoint_dir, "phema")
    if os.path.isdir(phema_dir):
        return phema_dir
    sibling = os.path.join(os.path.dirname(os.path.abspath(checkpoint_dir)), "phema")
    if os.path.isdir(sibling):
        return sibling
    raise FileNotFoundError(
        f"no phema snapshots at {phema_dir} or {sibling} - the sweep "
        "synthesizes EMA weights from PostHocEMA snapshots")


@click.command()
@click.argument("checkpoint_dir", type=click.Path(exists=True))
@click.option("--mode", type=click.Choice(
    ["diffusion_base", "consistency_base", "diffusion_decoder",
     "consistency_decoder", "autoencoder"]), required=True)
@click.option("--h5-file", required=True)
@click.option("--n-trials", type=int, default=40)
@click.option("--kid-n-images", type=int, default=256)
@click.option("--storage", default=None, help="JSONL trial store (resumable)")
@click.option("--optuna-export", default=None,
              help="also write trials as an Optuna-shaped JSON file")
@click.option("--prune-probability-threshold", type=float, default=0.05,
              help="prune when P(current beats any completed trial) < t; 0 disables")
@click.option("--n-startup-trials", type=int, default=7)
@click.option("--n-ei-candidates", type=int, default=24)
@click.option("--prior-weight", type=float, default=0.2)
@click.option("--min-ema-sigma", type=float, default=0.015)
@click.option("--max-ema-sigma", type=float, default=0.25)
@click.option("--min-guidance-scale", type=float, default=1.0)
@click.option("--max-guidance-scale", type=float, default=2.4)
@click.option("--guide-path", default=None)
@click.option("--seed", type=int, default=0)
@click.option("--device", default="cuda", show_default=True,
              help="--device cpu runs on the CPU")
def main(checkpoint_dir, mode, h5_file, n_trials, kid_n_images, storage,
         optuna_export, prune_probability_threshold, n_startup_trials,
         n_ei_candidates, prior_weight,
         min_ema_sigma, max_ema_sigma, min_guidance_scale, max_guidance_scale,
         guide_path, seed, device):
    """Sweep EMA sigma_rel (+ guidance scale) against stage KID."""
    import tempfile

    from terrain_diffusion_tpu_torch.common.cli_helpers import click_check_device
    from terrain_diffusion_tpu_torch.evaluation.stage_eval import run_stage_eval
    from terrain_diffusion_tpu_torch.nn import torch_compat
    from terrain_diffusion_tpu_torch.training.phema import PostHocEMA

    click_check_device(device)
    spec = {"ema_sigma": (min_ema_sigma, max_ema_sigma, True)}
    # guidance only where the eval stage actually consumes it (diffusion
    # sampling with a guide model); the consistency samplers take no guide,
    # so sweeping guidance there would optimize pure noise
    if guide_path and mode in ("diffusion_base", "diffusion_decoder"):
        spec["guidance_scale"] = (min_guidance_scale, max_guidance_scale, False)
    if mode == "consistency_base":
        # intermediate consistency step (reference sweep_consistency_base
        # tunes intermediate_sigma; inter_t = arctan(sigma/sigma_data))
        spec["inter_t"] = (0.3, 1.0, False)
    space = SweepSpace(spec)

    model = torch_compat.load_model(os.path.join(checkpoint_dir, "saved_model"),
                                    device=device)
    phema_dir = _phema_dir(checkpoint_dir)
    sweep_kw = dict(n_trials=n_trials, storage=storage, seed=seed,
                    prune_probability_threshold=(prune_probability_threshold or None),
                    n_startup_trials=n_startup_trials, n_ei_candidates=n_ei_candidates,
                    prior_weight=prior_weight)
    if mode == "autoencoder":
        # an autoencoder cannot be driven through the diffusion KID stages
        items = autoencoder_items(h5_file, kid_n_images, seed)
        best = run_sweep(autoencoder_objective(model, phema_dir, items, seed), space,
                         **sweep_kw)
        _export_trials(storage, optuna_export)
        return best
    stage = {"diffusion_base": "base_diffusion",
             "consistency_base": "base_consistency",
             "diffusion_decoder": "decoder_diffusion",
             "consistency_decoder": "decoder_consistency"}[mode]

    def objective(params, report):
        model.load_state_dict(PostHocEMA.synthesize_from_folder(
            phema_dir, params["ema_sigma"]), strict=False)
        with tempfile.TemporaryDirectory() as td:
            torch_compat.save_model(model, td)
            # two-phase evaluation: a quarter-budget KID estimate first so
            # clearly-losing trials prune before the full pass (the
            # reference prunes incrementally inside one pass; two fixed
            # phases approximate that at <=1.25x cost)
            quarter = max(kid_n_images // 4, 32)
            out = run_stage_eval(
                stage, td, h5_file, guide_path=guide_path,
                guidance_scale=params.get("guidance_scale", 1.0),
                inter_t=params.get("inter_t"),
                n_images=quarter, seed=seed, device=device)
            if report(out["kid_mean"], max(out["kid_std"], 1e-8)):
                return out["kid_mean"], max(out["kid_std"], 1e-8)
            out = run_stage_eval(
                stage, td, h5_file, guide_path=guide_path,
                guidance_scale=params.get("guidance_scale", 1.0),
                inter_t=params.get("inter_t"),
                n_images=kid_n_images, seed=seed, device=device)
        return out["kid_mean"], max(out["kid_std"], 1e-8)

    best = run_sweep(objective, space, **sweep_kw)
    _export_trials(storage, optuna_export)
    return best


if __name__ == "__main__":
    main()
