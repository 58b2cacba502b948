"""The port's training entry points and bookkeeping on the CPU
(terrain_diffusion_tpu_torch.training), against the JAX package where it has
the same function:
- the LR schedules, the PostHoc-EMA math (gamma, solve_weights, update,
  synthesize; 1e-7) and the config parser (every shipped .cfg) equal JAX's;
- the HDF5 datasets give JAX's items, bit for bit, on a tiny fixture;
- ``run_training`` for 3 steps, then a resume to step 5, is bit-identical
  to an uninterrupted 5-step run (weights, optimizer state, EMA);
- ``save_model``'s output loads in both packages' ``load_model`` with equal
  weights, and a consistency run distills from it;
- no module of the port imports JAX or the JAX package.
"""
import glob
import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from terrain_diffusion_tpu.training import lr_sched as jls
from terrain_diffusion_tpu.training import phema as jphema
from terrain_diffusion_tpu.training import registry as jreg

from terrain_diffusion_tpu_torch.nn.torch_compat import load_model, params_from_jax
from terrain_diffusion_tpu_torch.training import lr_sched as ls
from terrain_diffusion_tpu_torch.training import phema
from terrain_diffusion_tpu_torch.training import registry as reg
from terrain_diffusion_tpu_torch.training.diffusion_core import trained_tensors
from terrain_diffusion_tpu_torch.training.save_model import save_model
from terrain_diffusion_tpu_torch.training.train import run_training

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXACT = 1e-7


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op torch thread while this module runs: six pytest-xdist
    workers share the CPU, and torch's default of a thread per core makes
    each small op wait on descheduled siblings."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def h5_file(tmp_path_factory):
    """A tiny dataset in the reference schema:
    {res}/{chunk}/{subchunk}/{latent,lowfreq,lowres_exact,climate,residual}."""
    import h5py

    path = str(tmp_path_factory.mktemp("data") / "dataset.h5")
    rng = np.random.default_rng(0)
    with h5py.File(path, "w") as f:
        for chunk in range(2):
            for sub in range(2):
                g = f.create_group(f"90/{chunk}/{sub}")
                d = g.create_dataset("latent", data=rng.standard_normal(
                    (8, 8, 40, 40)).astype(np.float16))
                g.create_dataset("lowfreq", data=rng.standard_normal((40, 40)).astype(
                    np.float32) * 38 - 31)
                g.create_dataset("lowres_exact", data=rng.standard_normal((40, 40)).astype(
                    np.float32) * 100)
                g.create_dataset("climate", data=rng.standard_normal((19, 40, 40)).astype(
                    np.float32))
                r = g.create_dataset("residual", data=rng.standard_normal((320, 320)).astype(
                    np.float32))
                for dset in (d, r):
                    dset.attrs["pct_land"] = 0.5
                    dset.attrs["split"] = "train"
                g.attrs["beauty_score"] = float(1 + 2 * sub + chunk)
    return path


def _decoder_ds(h5, crop=32):
    return {"@dataset": "h5_decoder_terrain", "h5_file": h5, "crop_size": crop,
            "pct_land_ranges": [[0, 1]], "subset_resolutions": [90], "residual_mean": 0.0,
            "residual_std": 1.1678, "split": "train", "sigma_data": 0.5}


def _latents_ds(h5):
    return {"@dataset": "h5_latents", "h5_file": h5, "crop_size": 32,
            "pct_land_ranges": [[0, 1]], "subset_resolutions": [90],
            "latents_mean": [0, 0, 0, 0], "latents_std": [1, 1, 1, 1], "split": "train",
            "beauty_dist": True, "cond_input_dropout": 0.2, "cond_input_max_noise": 0.1,
            "cond_input_mean": [0, 0, 0, 0, 0, 0, 0.5], "cond_input_std": [1, 1, 1, 1, 1, 1, 0.5]}


def _diffusion_config(h5, save_dir):
    return {
        "trainer": {"@trainer": "diffusion"},
        "logging": {"save_dir": save_dir, "save_epochs": 1},
        "training": {"batch_size": 2, "epochs": 1, "epoch_steps": 3, "P_mean": -0.6,
                     "P_std": 1.3, "seed": 1, "gradient_clip_val": 1.0},
        "ema": {"sigma_rels": [0.05, 0.1], "checkpoint_every_num_steps": 2},
        "scheduler": {"@scheduler": "edm_dpm", "sigma_data": 0.5},
        "model": {"@model": "unet", "image_size": 32, "in_channels": 5, "out_channels": 1,
                  "model_channels": 8, "model_channel_mults": [1, 2], "layers_per_block": 1,
                  "attn_resolutions": [], "midblock_attention": False, "concat_balance": 0.5,
                  "fourier_scale": "pos", "noise_emb_dims": 8, "logvar_channels": 8,
                  "block_kwargs": {"dropout": 0.1}},
        "lr_sched": {"@lr_sched": "sqrt", "lr": 1e-2, "ref_nimg": 4, "warmup_nimg": 2},
        "train_dataset": _decoder_ds(h5),
    }


def _state(trainer, state):
    model = {k: v.detach().clone() for k, v in trainer.model.state_dict().items()}
    opt = state["opt_state"]
    return model, opt["count"], opt["mu"], opt["nu"], state["ema"].state_dict()["emas"]


def _assert_same(a, b):
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _assert_same(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        for x, y in zip(a, b, strict=True):
            _assert_same(x, y)
    elif isinstance(a, torch.Tensor):
        assert torch.equal(a.cpu(), b.cpu())
    else:
        assert a == b


# ---------------------------------------------------------------------------
# exact matches with JAX
# ---------------------------------------------------------------------------

def test_lr_schedules_equal_jax():
    pairs = [(ls.SqrtLRScheduler(0.01, 1310720, 327680), jls.SqrtLRScheduler(0.01, 1310720, 327680)),
             (ls.SqrtLRScheduler(0.005, 1000), jls.SqrtLRScheduler(0.005, 1000)),
             (ls.CosineLRScheduler(1e-3, 5e5, 1e4, 1e-5), jls.CosineLRScheduler(1e-3, 5e5, 1e4, 1e-5)),
             (ls.ConstantLRScheduler(1e-4, 300), jls.ConstantLRScheduler(1e-4, 300)),
             (ls.ConstantLRScheduler(1e-4), jls.ConstantLRScheduler(1e-4))]
    for port, ref in pairs:
        for nimg in (0, 1, 32, 299, 300, 9999, 1e4, 327680, 1310720, 5e5, 4e6):
            assert port.get(nimg) == ref.get(nimg)


def test_phema_math_equals_jax(tmp_path):
    for s in (0.015, 0.05, 0.1, 0.25):
        assert phema.sigma_rel_to_gamma(s) == jphema.sigma_rel_to_gamma(s)
    t_i, g_i = np.array([10.0, 20.0, 20.0, 40.0]), np.array([16.97, 6.94, 16.97, 6.94])
    np.testing.assert_array_equal(phema.solve_weights(t_i, g_i, 30.0, 10.0),
                                  jphema.solve_weights(t_i, g_i, 30.0, 10.0))
    rng = np.random.default_rng(3)
    init = {"w": rng.standard_normal((4, 5)).astype(np.float32),
            "b": rng.standard_normal((5,)).astype(np.float32)}
    port = phema.PostHocEMA({k: torch.from_numpy(v.copy()) for k, v in init.items()},
                            folder=str(tmp_path / "port"))
    ref = jphema.PostHocEMA({k: jnp.asarray(v) for k, v in init.items()},
                            folder=str(tmp_path / "jax"))
    for step in range(1, 31):
        p = {k: rng.standard_normal(v.shape).astype(np.float32) for k, v in init.items()}
        port.update({k: torch.from_numpy(v) for k, v in p.items()}, step)
        ref.update({k: jnp.asarray(v) for k, v in p.items()}, step)
        if step % 10 == 0:
            port.checkpoint(step)
            ref.checkpoint(step)
    for e_port, e_ref in zip(port.emas, ref.emas):
        for k in init:
            np.testing.assert_allclose(e_port[k].numpy(), np.asarray(e_ref[k]), rtol=0,
                                       atol=EXACT)
    for sr, step in ((0.07, None), (0.12, 20)):
        got, want = port.synthesize(sr, step), ref.synthesize(sr, step)
        for k in init:
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=0, atol=EXACT)


def test_load_config_of_every_shipped_config_equals_jax():
    paths = sorted(glob.glob(os.path.join(ROOT, "configs", "**", "*.cfg"), recursive=True))
    assert len(paths) >= 10
    for path in paths:
        assert reg.load_config(path) == jreg.load_config(path), path
    cfg = reg.load_config(paths[0])
    ovs = ["training.batch_size=3", "model.block_kwargs={\"dropout\": 0.2}", "a.b.c=x"]
    assert reg.apply_overrides(cfg, ovs) == jreg.apply_overrides(reg.load_config(paths[0]), ovs)


def test_datasets_give_jax_items(h5_file):
    from terrain_diffusion_tpu.training import datasets as jds

    from terrain_diffusion_tpu_torch.training import datasets as pds

    for make in (_decoder_ds, _latents_ds):
        kw = {k: v for k, v in make(h5_file).items() if not k.startswith("@")}
        cls = "H5DecoderTerrainDataset" if make is _decoder_ds else "H5LatentsDataset"
        port = pds.LongDataset(getattr(pds, cls)(**kw), base_seed=4)
        ref = jds.LongDataset(getattr(jds, cls)(**kw), base_seed=4)
        for i in (0, 1, 5):
            a, b = pds.collate([port[i]]), jds.collate([ref[i]])
            assert a.keys() == b.keys()
            for k in a:
                if isinstance(a[k], np.ndarray):
                    np.testing.assert_array_equal(a[k], b[k])
        batches = pds.batch_iterator(port, 2, start=4)
        first = next(batches)
        batches.close()
        np.testing.assert_array_equal(
            first["image"], pds.collate([port[4], port[5]])["image"])


def test_port_imports_neither_jax_nor_the_jax_package():
    pattern = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|optax|terrain_diffusion_tpu)\b(?!_)",
                         re.M)
    files = glob.glob(os.path.join(ROOT, "terrain_diffusion_tpu_torch", "**", "*.py"),
                      recursive=True) + [os.path.join(ROOT, "chip_smoke.py")]
    offenders = [f for f in files if pattern.search(open(f).read())]
    assert len(files) > 40 and not offenders


# ---------------------------------------------------------------------------
# the entry points
# ---------------------------------------------------------------------------

def test_resume_is_bit_identical(h5_file, tmp_path):
    cfg_a = _diffusion_config(h5_file, str(tmp_path / "a"))
    trainer, state, counters = run_training(cfg_a, max_steps=3, log_every=1, device="cpu")
    assert counters["step"] == 3 and counters["seen"] == 6
    ckpt = tmp_path / "a" / "latest_checkpoint"
    assert (ckpt / "saved_model" / "model.safetensors").exists()
    assert (ckpt / "train_state.pt").exists() and (tmp_path / "a" / "phema").is_dir()
    resumed = run_training(cfg_a, max_steps=5, log_every=1, device="cpu")
    straight = run_training(_diffusion_config(h5_file, str(tmp_path / "b")), max_steps=5,
                            log_every=1, device="cpu")
    assert resumed[2] == straight[2] == {"epoch": 1, "step": 5, "seen": 10}
    _assert_same(_state(*resumed[:2]), _state(*straight[:2]))
    lines = open(tmp_path / "b" / "metrics.jsonl").read().splitlines()
    assert len(lines) == 5 and all(np.isfinite(float(eval(ln)["loss"])) for ln in lines)


def test_saved_model_loads_in_both_packages_and_teaches(h5_file, tmp_path):
    from terrain_diffusion_tpu.nn import torch_compat as jcompat

    trainer, _, _ = run_training(_diffusion_config(h5_file, str(tmp_path / "d")), max_steps=2,
                                 log_every=1, device="cpu")
    ckpt = str(tmp_path / "d" / "latest_checkpoint")
    out = save_model(ckpt, out=str(tmp_path / "teacher"))
    port = load_model(out, device="cpu")
    jmodel, jparams = jcompat.load_model(out)
    want = params_from_jax(port, jparams)
    for name, t in trained_tensors(port).items():
        assert torch.equal(t.detach(), want[name]), name
        assert torch.equal(t.detach(), trainer.model.state_dict()[name].detach()), name
    ema_out = save_model(ckpt, sigma_rel=0.07, out=str(tmp_path / "teacher_ema"))
    assert jcompat.load_model(ema_out)[0].config.model_channels == 8

    config = {
        "trainer": {"@trainer": "consistency"},
        "logging": {"save_dir": str(tmp_path / "c"), "save_epochs": 1},
        "training": {"batch_size": 2, "epochs": 1, "epoch_steps": 2, "seed": 3,
                     "warmup_steps": 4, "gradient_clip_val": 5.0, "P_mean": -0.6,
                     "P_std": 2.0, "use_logvar": True},
        "model": {"main_path": out, "guide_path": ema_out, "guidance_scale": 1.265},
        "lr_sched": {"@lr_sched": "constant", "lr": 1e-4},
        "train_dataset": _decoder_ds(h5_file),
    }
    cons, state, counters = run_training(config, max_steps=2, log_every=1, device="cpu")
    assert counters["step"] == 2
    teacher = cons.teacher.state_dict()
    for name, t in port.state_dict().items():
        assert torch.equal(teacher[name], t), name
    assert all(not p.requires_grad for p in cons.teacher.parameters())
    lines = [eval(ln) for ln in open(tmp_path / "c" / "metrics.jsonl").read().splitlines()]
    assert [ln["r"] for ln in lines] == [0.25, 0.5]
    assert all(np.isfinite(ln["loss"]) and np.isfinite(ln["grad_norm"]) for ln in lines)


def test_cli_trains_on_the_cpu_when_asked(h5_file, tmp_path, monkeypatch):
    from click.testing import CliRunner

    from terrain_diffusion_tpu_torch.training import train

    path = tmp_path / "run.cfg"
    cfg = _diffusion_config(h5_file, str(tmp_path / "cli"))
    with open(path, "w") as f:
        for section, body in cfg.items():
            f.write(f"[{section}]\n")
            for k, v in body.items():
                f.write(f"{k}={__import__('json').dumps(v)}\n")
    assert reg.load_config(str(path)) == cfg
    runner = CliRunner()
    res = runner.invoke(train.main, ["--config", str(path), "--max-steps", "1",
                                     "--device", "cpu", "-o", "training.seed=9"])
    assert res.exit_code == 0, res.output
    assert (tmp_path / "cli" / "latest_checkpoint" / "train_state.pt").exists()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    res = runner.invoke(train.main, ["--config", str(path), "--max-steps", "1"])
    assert res.exit_code != 0 and "--device cpu" in res.output


def test_training_utils(tmp_path):
    from terrain_diffusion_tpu_torch.nn.edm_unet import EDMUnet2D, EDMUnetConfig
    from terrain_diffusion_tpu_torch.training.utils import (SerializableDict, safe_rmtree,
                                                            temporary_weights)

    counters = SerializableDict(epoch=1, step=5, seen=10)
    counters.step += 1
    counters.save(str(tmp_path / "c.json"))
    assert SerializableDict.load(str(tmp_path / "c.json")) == {"epoch": 1, "step": 6, "seen": 10}
    model = EDMUnet2D(EDMUnetConfig(image_size=16, in_channels=2, model_channels=8,
                                    model_channel_mults=(1,), layers_per_block=1),
                      device="cpu", generator=torch.Generator().manual_seed(0))
    before = {k: v.clone() for k, v in model.state_dict().items()}
    with temporary_weights(model, {"out_gain": torch.tensor(3.0)}):
        assert float(model.out_gain.detach()) == 3.0
    _assert_same(model.state_dict(), before)
    ckpt = tmp_path / "ckpt"
    ckpt.mkdir()
    (ckpt / "train_state.pt").write_bytes(b"x")
    (ckpt / "notes.md").write_text("keep")
    with pytest.raises(RuntimeError, match="notes.md"):
        safe_rmtree(str(ckpt))
    (ckpt / "notes.md").unlink()
    safe_rmtree(str(ckpt))
    assert not ckpt.exists()
