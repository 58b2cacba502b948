"""The port's autoencoder training (terrain_diffusion_tpu_torch.training:
``autoencoder_loss``, ``AutoencoderTrainer``, ``H5AutoencoderDataset``, the
LPIPS perceptual term) against the JAX package's, on the CPU, with a tiny
two-level VAE at 32 x 32.

The same weights cross (JAX's params_from_torch_state of the port's init,
so no JAX init compiles) and the same numpy batches go to both sides; the
posterior sample of a step comes from a threefry key seeded from the
step's generator, so JAX's trainer gets ``jax.random.key`` of the same seed
and draws the same eps.  Bars, as max|diff| / max|ref|:
- 1e-5 for the loss and its terms (a forward of the VAE and a reduction);
- 1e-4 for the parameters after two clipped Adam steps;
- 1e-5 for the perceptual terms (multi-scale gradients, LPIPS-Alex on a
  random torchvision-named state).
Also: the dataset's items bit-equal to JAX's on a tiny HDF5; ``train`` and
``save-model`` through the command group on autoencoder_x8.cfg and
autoencoder_x8_squared.cfg, the saved VAE loading in both packages; and the
routing: a training forward never reaches a kernel wrapper, a no_grad
forward reaches the wrappers, which on a CPU tensor run their plain
versions.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from terrain_diffusion_tpu.nn import torch_compat as jcompat
from terrain_diffusion_tpu.nn.edm_autoencoder import EDMAutoencoder as JaxAutoencoder
from terrain_diffusion_tpu.nn.edm_autoencoder import EDMAutoencoderConfig as JaxConfig
from terrain_diffusion_tpu.training import diffusion_core as jcore
from terrain_diffusion_tpu.training import lr_sched as jls
from terrain_diffusion_tpu.training.trainers import autoencoder as jae

from terrain_diffusion_tpu_torch import use_full_f32
from terrain_diffusion_tpu_torch.nn.edm_autoencoder import EDMAutoencoder, EDMAutoencoderConfig
from terrain_diffusion_tpu_torch.nn.torch_compat import params_from_jax
from terrain_diffusion_tpu_torch.ops.noise_field import key_from_seed
from terrain_diffusion_tpu_torch.training import diffusion_core as core
from terrain_diffusion_tpu_torch.training import lr_sched as ls
from terrain_diffusion_tpu_torch.training.diffusion_core import trained_tensors
from terrain_diffusion_tpu_torch.training.registry import ModelSpec
from terrain_diffusion_tpu_torch.training.trainers import autoencoder as pae
from test_torch_training_core import raising_kernels  # noqa: F401

use_full_f32()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOSS_TOL = 1e-5
STEP_TOL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op torch thread while this module runs (the tier-1 run has
    six pytest-xdist workers on the CPU)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel(got, want):
    if isinstance(got, torch.Tensor):
        got = got.detach().numpy()
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want)) / (np.max(np.abs(want)) + 1e-30))


def _cfg(size=32):
    return JaxConfig(image_size=size, in_channels=1, latent_channels=2, out_channels=1,
                     model_channels=8, model_channel_mults=(1, 2), layers_per_block=1,
                     attn_resolutions=(), midblock_attention=False, logvar_channels=8)


def _jax_params(jm, model):
    """JAX's parameter tree of the port's ``model`` (no JAX init to compile)."""
    return jcompat.params_from_torch_state(
        jm, {k: v.detach().numpy() for k, v in model.state_dict().items()})


def _pair(seed=0):
    jm = JaxAutoencoder(_cfg())
    pm = EDMAutoencoder(EDMAutoencoderConfig.from_dict(_cfg().to_dict()), device="cpu",
                        generator=torch.Generator().manual_seed(seed))
    with torch.no_grad():
        pm.out_gain.fill_(0.7)  # a lively reconstruction
    return jm, _jax_params(jm, pm), pm


def _images(rng, n=2, size=32):
    return rng.standard_normal((n, size, size, 1)).astype(np.float32) * 0.5


def _step_seed(k):
    """The seed of the key a step's generator gives (``key_from_generator``)."""
    return int(torch.randint(0, 2 ** 31, (1,), generator=torch.Generator().manual_seed(k)))


# ---------------------------------------------------------------------------
# the loss and its terms
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("perceptual", [False, True], ids=["mae-kl", "grad"])
def test_autoencoder_loss_on_jax_key(rng, perceptual):
    jm, params, pm = _pair()
    x = _images(rng)
    jfn = jae.multiscale_gradient_loss if perceptual else None
    pfn = pae.multiscale_gradient_loss if perceptual else None
    want, want_aux = jax.jit(lambda p, xx, k: jcore.autoencoder_loss(
        jm, p, {"image": xx}, k, kl_weight=0.3, perceptual_fn=jfn,
        perceptual_weight=0.5))(params, x, jax.random.key(7))
    got, aux = core.autoencoder_loss(pm, {"image": torch.from_numpy(x)}, key_from_seed(7),
                                     kl_weight=0.3, perceptual_fn=pfn, perceptual_weight=0.5)
    assert _rel(got, want) < LOSS_TOL
    assert aux.keys() == want_aux.keys()
    for k in aux:
        assert _rel(aux[k], want_aux[k]) < LOSS_TOL, k


def test_multiscale_gradient_loss_matches_jax(rng):
    a, b = _images(rng, 3, 24), _images(rng, 3, 24)
    want = jax.jit(jae.multiscale_gradient_loss)(jnp.asarray(a), jnp.asarray(b))
    got = pae.multiscale_gradient_loss(torch.from_numpy(a), torch.from_numpy(b))
    assert _rel(got, want) < LOSS_TOL


def test_lpips_perceptual_term_matches_jax(rng, tmp_path):
    """training.perceptual='lpips' from a weights file (a random
    torchvision-named state): the port's term equals JAX's."""
    from safetensors.numpy import save_file

    from terrain_diffusion_tpu.nn import lpips as jl

    path = str(tmp_path / "alex.safetensors")
    save_file(jl.random_torch_state(seed=5), path)
    want_fn = jl.make_perceptual_fn(jl.load_torch_checkpoint(path))
    got_fn = pae.perceptual_for({"perceptual": "lpips", "lpips_weights": path}, "cpu")
    recon, target = _images(rng, 2, 64) * 3, _images(rng, 2, 64)
    want = jax.jit(want_fn)(jnp.asarray(recon), jnp.asarray(target))
    with torch.no_grad():
        got = got_fn(torch.from_numpy(recon), torch.from_numpy(target))
    assert _rel(got, want) < LOSS_TOL
    assert pae.perceptual_for({"use_perceptual": False}, "cpu") is None
    with pytest.raises(ValueError, match="lpips_weights"):
        pae.perceptual_for({"perceptual": "lpips"}, "cpu")


# ---------------------------------------------------------------------------
# the trainer
# ---------------------------------------------------------------------------

def test_two_clipped_trainer_steps_match_jax(rng):
    """AutoencoderTrainer.train_step twice with clipping active (the grad
    perceptual term on): the parameters after each step, the loss and
    grad_norm against JAX's AutoencoderTrainer on the same key seeds."""
    clip, lr = 0.05, 2e-3
    config = {"training": {"gradient_clip_val": clip, "kl_weight": 0.01,
                           "perceptual_weight": 0.5},
              "optimizer": {"kwargs": {"betas": [0.9, 0.99]}}}
    jm = JaxAutoencoder(_cfg())
    jt = jae.AutoencoderTrainer(config, {"model": jm, "lr_sched": jls.ConstantLRScheduler(lr)})
    pt = pae.AutoencoderTrainer(config, {"model": ModelSpec(EDMAutoencoderConfig.from_dict(
        _cfg().to_dict())), "lr_sched": ls.ConstantLRScheduler(lr)}, device="cpu")
    state = pt.init_state(torch.Generator().manual_seed(0))
    jparams = _jax_params(jm, pt.model)  # JAX's init_state with the port's init weights
    jstate = {"params": jparams, "opt_state": jt.optimizer.init(jparams), "ema": None}
    jcounters, counters = {"step": 0, "seen": 0}, {"step": 0, "seen": 0}
    for k in (11, 12):
        batch = {"image": _images(rng)}
        jm = jt.train_step(jstate, batch, jax.random.key(_step_seed(k)), jcounters)
        m = pt.train_step(state, batch, torch.Generator().manual_seed(k), counters)
        assert jm["grad_norm"] > clip
        for name in ("loss", "grad_norm", "mae", "kl", "perceptual"):
            assert _rel(m[name], jm[name]) < STEP_TOL, (k, name)
        want = params_from_jax(pt.model, jax.tree.map(np.asarray, jstate["params"]))
        for name, p in trained_tensors(pt.model).items():
            assert _rel(p, want[name]) < STEP_TOL, (k, name, _rel(p, want[name]))
    assert counters == jcounters == {"step": 2, "seen": 4}
    assert state["opt_state"]["count"] == 2


def test_evaluate_matches_the_loss_in_eval_mode(rng):
    """evaluate: the mean loss and terms over the batches, one key a batch
    from the generator, in eval mode under no_grad; training mode after."""
    pt = pae.AutoencoderTrainer({"training": {"use_perceptual": False}},
                                {"model": ModelSpec(EDMAutoencoderConfig.from_dict(
                                    _cfg().to_dict())),
                                 "lr_sched": ls.ConstantLRScheduler(1e-3)}, device="cpu")
    state = pt.init_state(torch.Generator().manual_seed(0))
    batches = [{"image": _images(rng)} for _ in range(2)]
    out = pt.evaluate(state, batches, torch.Generator().manual_seed(5))
    g = torch.Generator().manual_seed(5)
    want = []
    with torch.no_grad():
        for b in batches:
            loss, _ = core.autoencoder_loss(pt.model, {"image": torch.from_numpy(b["image"])},
                                            core.key_from_generator(g), kl_weight=1e-5)
            want.append(float(loss))
    assert set(out) == {"val_loss", "val_mae", "val_kl"}
    assert out["val_loss"] == pytest.approx(np.mean(want), rel=1e-6)
    assert pt.model.training


# ---------------------------------------------------------------------------
# routing: no kernel where autograd records
# ---------------------------------------------------------------------------

def test_autoencoder_routing_at_128(rng, raising_kernels):  # noqa: F811
    """At 128 x 128 a training step's forward and backward never reach a
    kernel wrapper; an evaluation forward under no_grad reaches the block
    and conv wrappers (the blocks of at least 128 x 128 pixels, the in
    conv), which on a CPU tensor run their plain versions: the loss equals
    the one autograd records."""
    cfg = EDMAutoencoderConfig.from_dict(_cfg(128).to_dict())
    ae = EDMAutoencoder(cfg, device="cpu", generator=torch.Generator().manual_seed(2))
    x = torch.from_numpy(_images(rng, 1, 128))
    loss, _ = core.autoencoder_loss(ae, {"image": x}, key_from_seed(3))
    loss.backward()
    assert ae.encoder.enc["128x128_block0"].conv_res0.weight.grad.abs().sum() > 0
    calls = raising_kernels()
    with torch.no_grad():
        got, _ = core.autoencoder_loss(ae, {"image": x}, key_from_seed(3))
    enc128 = sum(1 for name, kind, *_ in ae.encoder.enc_plan
                 if kind == "block" and name.startswith("128x128"))
    dec128 = sum(1 for name, *_ in ae.decoder_plan  # up0 upsamples to 128 x 128
                 if name.startswith("128x128") or name == "up0")
    assert calls.count("fused_block") == enc128 + dec128 > 0
    assert calls.count("conv3x3") == 1
    assert _rel(got, loss.detach()) < 1e-6


# ---------------------------------------------------------------------------
# the dataset
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def h5_file(tmp_path_factory):
    """Residual subchunks in the reference schema, both land ranges of the
    shipped configs, train and val splits."""
    import h5py

    path = str(tmp_path_factory.mktemp("ae_data") / "dataset.h5")
    rng = np.random.default_rng(0)
    with h5py.File(path, "w") as f:
        for chunk in range(2):
            for sub, (pct, split) in enumerate([(0.005, "train"), (0.5, "train"),
                                                (0.005, "val"), (0.5, "val")]):
                d = f.create_group(f"90/{chunk}/{sub}").create_dataset(
                    "residual", data=rng.standard_normal((72, 80)).astype(np.float32) * 3)
                d.attrs["pct_land"] = pct
                d.attrs["split"] = split
    return path


def _ae_ds(h5, **kw):
    return {"h5_file": h5, "crop_size": 32, "pct_land_ranges": [[0, 0.01], [0.01, 1]],
            "subset_resolutions": [90, 90], "subset_weights": [0.3, 0.7],
            "residual_std": 1.1678, "split": "train", **kw}


@pytest.mark.parametrize("kw", [{}, {"signed_sqrt": False, "residual_std": 65.7},
                                {"eval_dataset": True, "split": "val"}],
                         ids=["signed-sqrt", "squared", "eval"])
def test_h5_autoencoder_items_equal_jax(h5_file, kw):
    from terrain_diffusion_tpu.training import datasets as jds

    from terrain_diffusion_tpu_torch.training import datasets as pds

    port = pds.LongDataset(pds.H5AutoencoderDataset(**_ae_ds(h5_file, **kw)), base_seed=2)
    ref = jds.LongDataset(jds.H5AutoencoderDataset(**_ae_ds(h5_file, **kw)), base_seed=2)
    for i in range(6):
        a, b = port[i], ref[i]
        assert a.keys() == b.keys() and a["path"] == b["path"]
        assert a["image"].shape == (32, 32, 1)
        np.testing.assert_array_equal(a["image"], b["image"])


# ---------------------------------------------------------------------------
# the entry points
# ---------------------------------------------------------------------------

TINY_VAE = ["model.image_size=32", "model.model_channels=8", "model.model_channel_mults=[1, 2]",
            "model.layers_per_block=1", "model.latent_channels=2", "training.batch_size=2",
            "ema.checkpoint_every_num_steps=1"]


@pytest.mark.parametrize("cfg", ["autoencoder_x8.cfg", "autoencoder_x8_squared.cfg"])
def test_train_and_save_model_through_the_cli(h5_file, tmp_path, cfg):
    """``train --device cpu --max-steps 2`` on the shipped config with a tiny
    model and data, then ``save-model --sigma-rel 0.1``: the saved VAE loads
    in both packages with the same weights (the forwards' parity is
    test_torch_autoencoder.py's)."""
    from click.testing import CliRunner

    from terrain_diffusion_tpu.nn import torch_compat as jcompat

    from terrain_diffusion_tpu_torch import __main__ as cli_main
    from terrain_diffusion_tpu_torch.nn import torch_compat

    save_dir = tmp_path / "run"
    data = [f"{s}.{k}={json.dumps(v)}" for s in ("train_dataset", "val_dataset")
            for k, v in (("h5_file", h5_file), ("crop_size", 32))]
    args = ["train", "--config", os.path.join(ROOT, "configs", "autoencoder", cfg),
            "--device", "cpu",
            "--max-steps", "2", "--log-every", "1"]
    for ov in TINY_VAE + data + [f"logging.save_dir={json.dumps(str(save_dir))}"]:
        args += ["-o", ov]
    runner = CliRunner()
    res = runner.invoke(cli_main.cli, args)
    assert res.exit_code == 0, res.output
    lines = [json.loads(ln) for ln in open(save_dir / "metrics.jsonl")]
    assert [ln["step"] for ln in lines] == [1, 2]
    assert all(np.isfinite(ln[k]) for ln in lines for k in ("loss", "mae", "kl", "perceptual"))
    ckpt = save_dir / "latest_checkpoint"
    res = runner.invoke(cli_main.cli, ["save-model", str(ckpt), "--sigma-rel", "0.1"])
    assert res.exit_code == 0, res.output
    out = str(ckpt / "saved_model_ema")
    port = torch_compat.load_model(out, device="cpu")
    jmodel, jparams = jcompat.load_model(out)
    assert isinstance(port, EDMAutoencoder) and isinstance(jmodel, JaxAutoencoder)
    want = params_from_jax(port, jparams)
    for name, t in trained_tensors(port).items():
        assert torch.equal(t.detach(), want[name]), name
