"""The PyTorch port's dataset-driven evaluations against the JAX package's,
on the CPU, on small HDF5 files in the reference schema: in-training KID
(``evaluate_kid``, ``DiffusionTrainer.evaluate_full``), the per-stage
FID / KID CLI core (``run_stage_eval``) and the InfiniteDiffusion quality
evaluation (``infinite_consistency.evaluate`` and ``generate_samples``).

Both packages get the same tiny models (tests/helpers.py::tiny_models'
configs with nonzero gains, saved by the port in the reference layout and
read by both), the same files and the same seeds, so the same keys.
Bar: 1e-3 relative on KID and FID (samples agree to float32 summation
order, the metrics then run in float64 numpy on both sides); the generated
terrain within 1e-3 relative RMSE.
"""
import jax
import numpy as np
import pytest
import torch


from terrain_diffusion_tpu_torch import use_full_f32
from terrain_diffusion_tpu_torch.nn import torch_compat
from terrain_diffusion_tpu_torch.ops.noise_field import key_from_seed

from test_torch_evaluation import TINY, tiny_pair

use_full_f32()
METRIC_TOL = 1e-3
CANVAS = 128  # latent px of the InfiniteDiffusion canvas (naive mode needs a 6x6 cond image)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op torch thread while this module runs: with six pytest-xdist
    workers on the CPU, torch's default of a thread per core makes each small
    op of the tiny models wait on descheduled siblings."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got: dict, want: dict, keys):
    for k in keys:
        assert np.isfinite(got[k]), (k, got[k])
        assert abs(got[k] - want[k]) <= METRIC_TOL * abs(want[k]), (k, got[k], want[k])


def _whole_set_std(got: dict, want: dict, key: str):
    """In-training KID draws subsets of min(n, 64) images: with n = 4 every
    subset is the whole set, so the std over subsets is rounding noise on
    both sides (0 up to float64 rounding), not a number to compare."""
    assert abs(got[key]) < 1e-9 and abs(want[key]) < 1e-9, (got[key], want[key])


@pytest.fixture(scope="module")
def h5_file(tmp_path_factory):
    """Latents, lowfreq, conditioning and a structured residual (smooth hills
    plus mild noise, so real terrain differs from generated) in two val
    chunks, large enough for a 128-latent-px canvas."""
    import h5py

    path = str(tmp_path_factory.mktemp("data") / "eval.h5")
    rng = np.random.default_rng(0)
    yy, xx = np.mgrid[0:1024, 0:1024]
    with h5py.File(path, "w") as f:
        for chunk in range(2):
            g = f.create_group(f"90/{chunk}/0")
            d = g.create_dataset("latent", data=rng.standard_normal(
                (8, 8, 128, 128)).astype(np.float16))
            d.attrs["pct_land"], d.attrs["split"] = 0.5, "val"
            g.create_dataset("lowfreq", data=rng.standard_normal(
                (128, 128)).astype(np.float32) * 38 - 31)
            g.create_dataset("lowres_exact", data=rng.standard_normal(
                (128, 128)).astype(np.float32) * 100)
            g.create_dataset("climate", data=rng.standard_normal(
                (19, 128, 128)).astype(np.float32))
            res = (np.sin(yy / 37.0 + chunk) * np.cos(xx / 53.0) * 12.0
                   + rng.standard_normal((1024, 1024)) * 0.1).astype(np.float32)
            r = g.create_dataset("residual", data=res)
            r.attrs["pct_land"], r.attrs["split"] = 0.5, "val"
            g.attrs["beauty_score"] = 3.0
    return path


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    """The tiny base and decoder (`test_torch_evaluation.TINY`, lively),
    saved by the port in the reference layout: {name: (jax model, jax
    params, path)}."""
    root = tmp_path_factory.mktemp("models")
    out = {}
    for seed, name in enumerate(("base", "decoder")):
        jm, params, pm = tiny_pair(TINY[name], seed)
        torch_compat.save_model(pm, str(root / name))
        out[name] = (jm, params, str(root / name))
    return out


def _ds_kwargs(h5_file, crop):
    return dict(h5_file=h5_file, crop_size=crop, pct_land_ranges=[[0, 1]],
                subset_resolutions=[90], subset_weights=[1.0], latents_mean=[0, 0, 0, 0],
                latents_std=[1, 1, 1, 1], split="val", clip_edges=False,
                cond_input_mean=[0, 0, 0, 0, 0, 0, 0.5], cond_input_std=[1, 1, 1, 1, 1, 1, 0.5])


def _datasets(h5_file, crop=64, **kw):
    from terrain_diffusion_tpu.training.datasets import H5LatentsDataset as JaxDataset

    from terrain_diffusion_tpu_torch.training.datasets import H5LatentsDataset

    kwargs = {**_ds_kwargs(h5_file, crop), **kw}
    return H5LatentsDataset(**kwargs), JaxDataset(**kwargs)


def test_evaluate_kid_matches_jax(h5_file, saved):
    """Consistency base samples decoded to terrain against the items' real
    ground truth (``test_evaluate_full_matches_jax`` runs the diffusion
    sampler)."""
    from terrain_diffusion_tpu.training.trainers.eval_kid import evaluate_kid as jax_kid

    from terrain_diffusion_tpu_torch.training.trainers.eval_kid import evaluate_kid

    ds, jds = _datasets(h5_file, val_dset=True)
    base, decoder = (torch_compat.load_model(saved[n][2], device="cpu")
                     for n in ("base", "decoder"))
    kw = dict(mode="base", n_images=4, batch=2, steps=2, sampler="consistency", inter_t=1.1)
    got = evaluate_kid(base, ds, key_from_seed(3), decoder=decoder, **kw)
    want = jax_kid(saved["base"][0], saved["base"][1], jds, jax.random.key(3),
                   decoder=saved["decoder"][:2], **kw)
    assert got["n_images"] == want["n_images"] == 4
    _close(got, want, ("kid_mean",))
    _whole_set_std(got, want, "kid_std")


def test_evaluate_full_matches_jax(h5_file, saved):
    """Validation loss plus KID with the EMA weights, the decoder read from
    ``[evaluation] kid_autoencoder_path``; the KID agrees with JAX's."""
    from terrain_diffusion_tpu.training import lr_sched as jls
    from terrain_diffusion_tpu.training.trainers.base import ema_for as jax_ema_for
    from terrain_diffusion_tpu.training.trainers.diffusion import \
        DiffusionTrainer as JaxTrainer

    from terrain_diffusion_tpu_torch.nn.edm_unet import EDMUnetConfig
    from terrain_diffusion_tpu_torch.training import lr_sched
    from terrain_diffusion_tpu_torch.training.registry import ModelSpec
    from terrain_diffusion_tpu_torch.training.trainers.base import ema_for
    from terrain_diffusion_tpu_torch.training.trainers.diffusion import DiffusionTrainer

    model, params, _ = saved["base"]
    config = {"training": {"P_mean": -0.6, "P_std": 1.3}, "optimizer": {},
              "evaluation": {"validate_epochs": 1, "validation_steps": 4, "kid_batch_size": 2,
                             "kid_enabled": True, "kid_n_images": 4, "kid_scheduler_steps": 2,
                             "kid_autoencoder_path": saved["decoder"][2], "mode": "base"}}
    ds, jds = _datasets(h5_file, val_dset=True)
    jtrainer = JaxTrainer(config, {"model": model, "lr_sched": jls.ConstantLRScheduler(1e-4)})
    # the saved lively weights and an EMA of them alone (evaluate_full reads no
    # optimizer state; init_state would compile JAX's init for nothing)
    jstate = {"params": params, "ema": jax_ema_for(params, config, None)}
    want = jtrainer.evaluate_full(jstate, jds, jax.random.key(1))

    trainer = DiffusionTrainer(config, {"model": ModelSpec(EDMUnetConfig.from_dict(
        model.config.to_dict())), "lr_sched": lr_sched.ConstantLRScheduler(1e-4)}, device="cpu")
    state = trainer.init_state(torch.Generator().manual_seed(0))
    with torch.no_grad():
        trainer.model.load_state_dict(torch_compat.params_from_jax(trainer.model, params))
    state["ema"] = ema_for(trainer.params(), config, None)
    got = trainer.evaluate_full(state, ds, torch.Generator().manual_seed(1),
                                key=key_from_seed(1))
    assert set(got) == set(want)
    assert np.isfinite(got["val_loss"]) and got["val_n_images"] == 4
    _close(got, want, ("val_kid_mean",))
    _whole_set_std(got, want, "val_kid_std")
    assert trainer.model.training  # evaluation leaves the trained model in train mode


@pytest.mark.parametrize("stage", ["base_diffusion", "base_consistency",
                                   "decoder_consistency", "decoder_diffusion"])
def test_run_stage_eval_matches_jax(h5_file, saved, stage):
    from terrain_diffusion_tpu.evaluation.stage_eval import run_stage_eval as jax_stage_eval

    from terrain_diffusion_tpu_torch.evaluation.stage_eval import run_stage_eval

    path = saved["base" if stage.startswith("base") else "decoder"][2]
    kw = dict(n_images=4, batch=2, steps=2, seed=5)
    got = run_stage_eval(stage, path, h5_file, device="cpu", **kw)
    want = jax_stage_eval(stage, path, h5_file, **kw)
    assert got["n_images"] == want["n_images"] == 4 and got["stage"] == stage
    _close(got, want, ("kid_mean", "kid_std", "fid"))


def test_infinite_consistency_evaluate_matches_jax(h5_file, saved):
    from terrain_diffusion_tpu.evaluation.infinite_consistency import evaluate as jax_evaluate

    from terrain_diffusion_tpu_torch.evaluation.infinite_consistency import evaluate

    kwargs = _ds_kwargs(h5_file, 96)
    kwargs.pop("crop_size")  # evaluate() sets crop_size = canvas
    paths = saved["base"][2], saved["decoder"][2]
    kw = dict(n_images=4, batch=2, mode="blend", seed=0, canvas=96)
    got = evaluate(*paths, kwargs, device="cpu", **kw)
    want = jax_evaluate(*paths, kwargs, **kw)
    assert got["n_images"] == 4 and got["mode"] == "blend"
    _close(got, want, ("kid_mean", "kid_std", "fid"))


@pytest.mark.parametrize("mode", ["naive", "skip-edge"])
def test_generate_samples_matches_jax(h5_file, saved, mode):
    from terrain_diffusion_tpu.evaluation.infinite_consistency import \
        generate_samples as jax_generate

    from terrain_diffusion_tpu_torch.evaluation.infinite_consistency import (generate_samples,
                                                                             real_terrain_batch)

    ds, _ = _datasets(h5_file, crop=CANVAS, val_dset=True)
    items = [ds[0]]
    cond = np.stack([i["cond_inputs_img"] for i in items])
    stats = np.zeros(7, np.float32), np.ones(7, np.float32)
    base, decoder = (torch_compat.load_model(saved[n][2], device="cpu")
                     for n in ("base", "decoder"))
    got = generate_samples(base, decoder, cond, *stats, key=key_from_seed(2), mode=mode,
                           canvas=CANVAS)
    want = jax_generate(*saved["base"][:2], *saved["decoder"][:2], cond, *stats,
                        key=jax.random.key(2), mode=mode, canvas=CANVAS)
    assert got.shape == want.shape == (1, 512, 512, 1)
    err = np.sqrt(np.mean((got - np.asarray(want)) ** 2) / np.mean(np.asarray(want) ** 2))
    assert err < METRIC_TOL
    real = real_terrain_batch(items, 512)
    assert real.shape == (1, 512, 512, 1) and np.isfinite(real).all()
    with pytest.raises(ValueError, match="ground_truth"):
        real_terrain_batch([{"image": None}], 512)


def test_stage_eval_cli(h5_file, saved):
    """The click entry point as a user runs it, on the CPU: one JSON result."""
    import json

    from click.testing import CliRunner

    from terrain_diffusion_tpu_torch.evaluation.stage_eval import main

    result = CliRunner().invoke(main, [saved["decoder"][2], "--stage", "decoder_consistency",
                                       "--h5-file", h5_file, "--n-images", "4", "--batch", "2",
                                       "--device", "cpu"])
    assert result.exit_code == 0, result.output
    out = json.loads(result.output)
    assert out["stage"] == "decoder_consistency" and out["n_images"] == 4
    assert all(np.isfinite(out[k]) for k in ("kid_mean", "kid_std", "fid"))
