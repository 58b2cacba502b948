"""The port's hyperparameter sweeps (``training/sweeps/sweep.py``) against
the JAX package's, on the CPU.

The TPE sampler, the Halton startup, the pruning rule, the JSONL trial
store (with its resume) and the Optuna JSON files are host numpy copied
from JAX: under the same seed they must give the same suggestions, trial
lists and bytes, bit for bit.  The autoencoder objective (EMA weights
synthesized from PostHocEMA snapshots, the VAE's validation MAE + KL) runs
on the port's tiny VAE and on JAX's with the same weights, snapshots (the
port's ``.pt`` files and JAX's ``.pkl`` files of the same states) and HDF5
items: trial values within 1e-5 relative, the trials' parameters equal.
"""
import json
import os
import pickle
import shutil

import numpy as np
import pytest
import torch

from terrain_diffusion_tpu.training.sweeps import sweep as jax_sweep

from terrain_diffusion_tpu_torch import use_full_f32
from terrain_diffusion_tpu_torch.nn import torch_compat
from terrain_diffusion_tpu_torch.nn.edm_autoencoder import EDMAutoencoder, EDMAutoencoderConfig
from terrain_diffusion_tpu_torch.training.sweeps import sweep

use_full_f32()
VALUE_TOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op torch thread while this module runs (six pytest-xdist
    workers share the CPU)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


SPACE = {"x": (0.0, 1.0, False), "y": (0.1, 10.0, True), "z": (-2.0, 3.0, False)}


def _bowl(p):
    return (p["x"] - 0.3) ** 2 + (np.log10(p["y"]) - 0.5) ** 2 + 0.1 * (p["z"] - 1.0) ** 2


def test_halton_and_quasirandom_equal_jax():
    for base in (2, 3, 5, 7, 11, 13):
        assert [sweep.halton(i, base) for i in range(50)] == \
               [jax_sweep.halton(i, base) for i in range(50)]
    space, jspace = sweep.SweepSpace(SPACE), jax_sweep.SweepSpace(SPACE)
    assert [space.sample_quasirandom(i) for i in range(20)] == \
           [jspace.sample_quasirandom(i) for i in range(20)]


@pytest.mark.parametrize("seed,gamma,prior_weight", [(0, 0.25, 1.0), (7, 0.4, 0.2)])
def test_tpe_suggestions_equal_jax(seed, gamma, prior_weight):
    """Suggestions after the startup trials, on trial histories drawn from a
    seed: the same floats, draw after draw."""
    rng = np.random.default_rng(seed)
    kw = dict(n_startup_trials=3, n_ei_candidates=24, gamma=gamma, prior_weight=prior_weight,
              seed=seed)
    tpe = sweep.TPESampler(sweep.SweepSpace(SPACE), **kw)
    jtpe = jax_sweep.TPESampler(jax_sweep.SweepSpace(SPACE), **kw)
    trials = []
    for i in range(12):
        got, want = tpe.suggest(trials), jtpe.suggest(trials)
        assert got == want
        trials.append({"params": got, "value": float(rng.standard_normal()) + _bowl(got),
                       "index": i})


@pytest.mark.parametrize("threshold", [None, 0.05])
def test_run_sweep_trials_equal_jax(tmp_path, threshold):
    """run_sweep with a reporting objective: the port's JSONL store equals
    JAX's byte for byte, and so does the best trial."""

    def objective(p, report):
        mean = _bowl(p)
        for std in (0.05, 0.02, 0.005):
            if report(mean, std):
                return mean, std
        return mean, 0.005

    kw = dict(n_trials=16, seed=3, prune_probability_threshold=threshold, n_startup_trials=5,
              n_ei_candidates=24, prior_weight=0.2)
    store, jstore = str(tmp_path / "port.jsonl"), str(tmp_path / "jax.jsonl")
    best = sweep.run_sweep(objective, sweep.SweepSpace(SPACE), storage=store, **kw)
    jbest = jax_sweep.run_sweep(objective, jax_sweep.SweepSpace(SPACE), storage=jstore, **kw)
    assert best == jbest
    assert open(store).read() == open(jstore).read()
    if threshold is not None:
        assert any(json.loads(line)["pruned"] for line in open(store))


def test_store_resumes_across_packages(tmp_path):
    """A store JAX started is resumed by the port: the trials the port adds
    are JAX's own continuation."""
    space = {"x": (0.0, 1.0, False)}

    def objective(p):
        return (p["x"] - 0.4) ** 2

    mixed, jax_only = str(tmp_path / "mixed.jsonl"), str(tmp_path / "jax.jsonl")
    jax_sweep.run_sweep(objective, jax_sweep.SweepSpace(space), n_trials=5, storage=mixed,
                        seed=0, n_startup_trials=3)
    best = sweep.run_sweep(objective, sweep.SweepSpace(space), n_trials=10, storage=mixed,
                           seed=0, n_startup_trials=3)
    jax_sweep.run_sweep(objective, jax_sweep.SweepSpace(space), n_trials=5, storage=jax_only,
                        seed=0, n_startup_trials=3)
    jbest = jax_sweep.run_sweep(objective, jax_sweep.SweepSpace(space), n_trials=10,
                                storage=jax_only, seed=0, n_startup_trials=3)
    assert open(mixed).read() == open(jax_only).read() and best == jbest
    assert len(open(mixed).read().splitlines()) == 10


def test_prune_probability_equal_jax():
    rng = np.random.default_rng(1)
    for _ in range(200):
        trials = [{"value": float(v), "value_std": (float(s) if s > 0.2 else None),
                   "pruned": bool(pr)}
                  for v, s, pr in zip(rng.normal(size=4), rng.random(4), rng.random(4) < 0.2)]
        mean, std = float(rng.normal()), float(rng.random() * 0.5)
        thr = float(rng.random() * 0.2)
        assert sweep.prune_probability(mean, std, trials, thr) == \
               jax_sweep.prune_probability(mean, std, trials, thr)


def test_optuna_json_equal_jax(tmp_path):
    trials = [
        {"index": 0, "params": {"x": 0.2}, "value": 1.0, "value_std": 0.1, "pruned": False},
        {"index": 1, "params": {"x": 0.7}, "value": 2.0, "value_std": None, "pruned": True},
        {"index": 2, "params": {"x": 0.1, "y": 3.5}, "value": 0.25, "value_std": 1e-8,
         "pruned": False},
    ]
    path, jpath = str(tmp_path / "port.json"), str(tmp_path / "jax.json")
    sweep.export_optuna_trials(trials, path)
    jax_sweep.export_optuna_trials(trials, jpath)
    assert open(path, "rb").read() == open(jpath, "rb").read()
    raw = json.load(open(path))
    raw.append({"params": {"x": 0.5}, "values": [0.75], "state": "TrialState.COMPLETE"})
    raw.append({"params": {"x": 0.9}, "state": "FAIL"})  # no value: skipped
    json.dump(raw, open(path, "w"))
    assert sweep.import_optuna_trials(path) == jax_sweep.import_optuna_trials(path)


@pytest.fixture(scope="module")
def vae_checkpoint(tmp_path_factory):
    """A checkpoint directory (saved_model beside phema/) of a tiny VAE, two
    snapshot states at steps 20 and 40 written both as the port's ``.pt``
    and JAX's ``.pkl``, and an HDF5 file of residuals for the validation
    items."""
    import h5py

    root = tmp_path_factory.mktemp("sweep")
    cfg = EDMAutoencoderConfig(image_size=64, in_channels=1, latent_channels=2,
                               model_channels=8, model_channel_mults=(1, 2), layers_per_block=1,
                               midblock_attention=False, logvar_channels=8)
    model = EDMAutoencoder(cfg, device="cpu", generator=torch.Generator().manual_seed(4))
    ckpt = root / "latest_checkpoint"
    torch_compat.save_model(model, str(ckpt / "saved_model"))
    phema = root / "phema"
    phema.mkdir()
    rng = np.random.default_rng(4)
    for step in (20, 40):
        for sr in (0.05, 0.1):
            with torch.no_grad():
                for name, p in model.named_parameters():
                    p.add_(torch.from_numpy(rng.standard_normal(p.shape).astype(np.float32))
                           * (0.3 if name.endswith("gain") else 0.02))
            state = {k: v.detach().clone() for k, v in model.named_parameters()}
            torch.save(state, str(phema / f"{sr}.{step}.pt"))
            with open(str(phema / f"{sr}.{step}.pkl"), "wb") as f:
                pickle.dump(torch_compat.params_to_jax(model), f)
    h5 = str(root / "ae.h5")
    with h5py.File(h5, "w") as f:
        for chunk in range(2):
            r = f.create_dataset(f"90/{chunk}/0/residual", data=rng.standard_normal(
                (256, 256)).astype(np.float32))
            r.attrs["pct_land"] = 0.5
            r.attrs["split"] = "val"
    return str(ckpt), h5


def test_autoencoder_sweep_equals_jax(vae_checkpoint, tmp_path):
    """Both packages' ``main --mode autoencoder``, 3 trials (2 startup) on 16
    items: the port's trials have JAX's parameters and values within 1e-5,
    its store resumes, and its Optuna export has JAX's shape."""
    ckpt, h5 = vae_checkpoint
    args = [ckpt, "--mode", "autoencoder", "--h5-file", h5, "--n-trials", "3",
            "--n-startup-trials", "2", "--kid-n-images", "16", "--seed", "5"]
    store, jstore = str(tmp_path / "port.jsonl"), str(tmp_path / "jax.jsonl")
    optuna = str(tmp_path / "port_optuna.json")
    best = sweep.main(args + ["--storage", store, "--optuna-export", optuna, "--device", "cpu"],
                      standalone_mode=False)
    jax_sweep.main(args + ["--storage", jstore], standalone_mode=False)
    got = [json.loads(line) for line in open(store)]
    want = [json.loads(line) for line in open(jstore)]
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert g["params"] == w["params"] and g["pruned"] == w["pruned"]
        assert abs(g["value"] - w["value"]) <= VALUE_TOL * abs(w["value"])
        assert np.isfinite(g["value"]) and g["value_std"] > 0
    assert best["value"] == min(t["value"] for t in got if not t["pruned"])
    assert [t["value"] for t in sweep.import_optuna_trials(optuna)] == [t["value"] for t in got]
    # resumed: a second call with the same store adds only the missing trial
    first = open(store).readlines()
    sweep.main(args[:6] + ["4"] + args[7:] + ["--storage", store, "--device", "cpu"],
               standalone_mode=False)
    lines = open(store).readlines()
    assert lines[:3] == first and len(lines) == 4


def test_objective_takes_items(vae_checkpoint):
    """``autoencoder_objective`` scores the items it is given: the same
    items give the same value, other items another."""
    ckpt, h5 = vae_checkpoint
    model = torch_compat.load_model(os.path.join(ckpt, "saved_model"), device="cpu")
    phema = os.path.join(os.path.dirname(ckpt), "phema")
    items = sweep.autoencoder_items(h5, 8, seed=1)
    assert len(items) == 8 and items[0]["image"].shape == (64, 64, 1)
    fn = sweep.autoencoder_objective(model, phema, items, seed=1)
    never = lambda m, s: False  # noqa: E731
    a, b = fn({"ema_sigma": 0.07}, never), fn({"ema_sigma": 0.07}, never)
    c = sweep.autoencoder_objective(model, phema, items[::-1][:4] * 2, seed=1)(
        {"ema_sigma": 0.07}, never)
    assert a == b and np.isfinite(a[0]) and c[0] != a[0]


def test_sweep_defaults_to_the_card(vae_checkpoint, monkeypatch, tmp_path):
    """Without a card the sweep exits with a usage error naming --device
    cpu before it loads anything; without snapshots it names phema."""
    import click

    ckpt, h5 = vae_checkpoint
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(click.UsageError, match="--device cpu"):
        sweep.main([ckpt, "--mode", "autoencoder", "--h5-file", h5], standalone_mode=False)
    lone = tmp_path / "run" / "latest_checkpoint"
    shutil.copytree(os.path.join(ckpt, "saved_model"), str(lone / "saved_model"))
    with pytest.raises(FileNotFoundError, match="phema"):
        sweep.main([str(lone), "--mode", "autoencoder", "--h5-file", h5, "--device", "cpu"],
                   standalone_mode=False)
