"""The rest of the port's training and evaluation models against the JAX
package's, on the CPU: LPIPS-Alex, the perceptron and its trainer, the
coarse / biome / file_gan / superres datasets, the GAN trainer, the
Inception features, and the registries.

Bars, as max|diff| / max|ref|:
- 1e-5 for the LPIPS distance, the perceptron's logits and the GAN's losses;
- 1e-4 for parameters after a training step and the Inception pool3
  features (90-odd conv layers deep);
- 1e-6 for the bilinear resize;
- bit equality for every dataset item, the coarse HDF5's bands and attrs,
  ``fill_oceans`` and ``_area_resize``.
Random numbers that JAX draws inside a step (the perceptron's dropout, the
GAN's latents, t, fixed share, image noise and crop offsets) go to the port
as arrays: the test splits JAX's keys as the JAX trainer does.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from terrain_diffusion_tpu.nn import EDMUnet2D as JaxEDMUnet2D
from terrain_diffusion_tpu.nn import EDMUnetConfig as JaxEDMUnetConfig
from terrain_diffusion_tpu.training import lr_sched as jls

from terrain_diffusion_tpu_torch import use_full_f32
from terrain_diffusion_tpu_torch.common.geotiff import Affine, write_geotiff
from terrain_diffusion_tpu_torch.nn.edm_unet import EDMUnetConfig
from terrain_diffusion_tpu_torch.nn.torch_compat import params_from_jax
from terrain_diffusion_tpu_torch.training import lr_sched as ls
from terrain_diffusion_tpu_torch.training.diffusion_core import trained_tensors
from terrain_diffusion_tpu_torch.training.registry import ModelSpec

use_full_f32()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-5
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


def _assert_items_equal(a, b):
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], list):
            assert len(a[k]) == len(b[k])
            for x, y in zip(a[k], b[k]):
                np.testing.assert_array_equal(x, y)
        elif isinstance(a[k], np.ndarray) or np.isscalar(a[k]):
            np.testing.assert_array_equal(a[k], b[k])
        else:
            assert a[k] == b[k]


# ---------------------------------------------------------------------------
# LPIPS
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("spatial", [True, False])
def test_lpips_distance_matches_jax(rng, spatial):
    from terrain_diffusion_tpu.nn import lpips as jl

    from terrain_diffusion_tpu_torch.nn import lpips

    state = jl.random_torch_state(seed=11)
    x0 = rng.uniform(-1, 1, (2, 64, 72, 3)).astype(np.float32)
    x1 = rng.uniform(-1, 1, (2, 64, 72, 3)).astype(np.float32)
    want = jax.jit(lambda p, a, b: jl.lpips_distance(p, a, b, spatial=spatial))(
        jl.params_from_torch_state(state), jnp.asarray(x0), jnp.asarray(x1))
    net = lpips.from_state_dict(state)
    with torch.no_grad():
        got = net(torch.from_numpy(x0), torch.from_numpy(x1), spatial=spatial)
    assert got.shape == want.shape == ((2, 64, 72, 1) if spatial else (2,))
    assert _rel(got, want) < TOL
    keyed = {("net.slice1." + k[len("features."):] if k.startswith("features.") else
              k.replace(".model.1", "")): v for k, v in state.items()}
    again = lpips.from_state_dict(keyed)  # the lpips package's spellings
    for name, t in net.state_dict().items():
        assert torch.equal(t, again.state_dict()[name]), name


# ---------------------------------------------------------------------------
# perceptron
# ---------------------------------------------------------------------------

def _perceptron_pair(**kw):
    from terrain_diffusion_tpu.nn.perceptron import Perceptron as JaxPerceptron
    from terrain_diffusion_tpu.nn.perceptron import PerceptronConfig as JaxPerceptronConfig

    from terrain_diffusion_tpu_torch.nn.perceptron import Perceptron, PerceptronConfig

    jcfg = JaxPerceptronConfig(in_dim=4, out_dim=5, hidden_dims=(16, 12), **kw)
    jm = JaxPerceptron(jcfg)
    jp = jax.jit(jm.init)(jax.random.key(2))
    jp = jax.tree.map(lambda a: a + 0.05 if a.ndim == 1 else a, jp)  # non-zero biases
    pm = Perceptron(PerceptronConfig.from_dict(jcfg.to_dict()), device="cpu",
                    generator=torch.Generator().manual_seed(0))
    pm.load_state_dict(params_from_jax(pm, jp))
    return jm, jp, pm


def _jax_dropout_masks(key, n, dims, drop):
    """The keep masks JAX's Perceptron.apply draws from ``key`` (one member)."""
    def masks(key):
        _key, dk = jax.random.split(key)
        out = []
        for d in dims:
            dk, sub = jax.random.split(dk)
            out.append(jax.random.bernoulli(sub, 1.0 - drop, (n, d)))
        return out

    return [[torch.from_numpy(np.array(m)) for m in jax.jit(masks)(key)]]


@pytest.mark.parametrize("kw", [{"activation": "gelu", "dropout": 0.3},
                                {"activation": "tanh", "final_activation": "silu",
                                 "random_ensembles": 3}], ids=["dropout", "ensembles"])
def test_perceptron_forward_matches_jax(rng, kw):
    jm, jp, pm = _perceptron_pair(**kw)
    x = rng.standard_normal((6, 4)).astype(np.float32)
    with torch.no_grad():
        assert _rel(pm(torch.from_numpy(x)), jax.jit(jm.apply)(jp, x)) < TOL  # eval: member 0
        if kw.get("dropout"):
            key = jax.random.key(9)
            keep = _jax_dropout_masks(key, 6, [16, 12], 0.3)
            got = pm(torch.from_numpy(x), draws={"keep": keep})
            want = jax.jit(lambda p, xx, k: jm.apply(p, xx, key=k, training=True))(jp, x, key)
            assert _rel(got, want) < TOL
        else:
            idx = np.array([2, 0, 1, 1, 2, 0])
            got = pm(torch.from_numpy(x), ensemble_idx=torch.from_numpy(idx))
            want = jax.jit(lambda p, xx, i: jm.apply(p, xx, ensemble_idx=i))(jp, x, idx)
            assert _rel(got, want) < TOL
    assert [n for n, _ in pm.named_parameters()][:2] == (
        ["nets.0.0.weight", "nets.0.0.bias"])


def test_perceptron_trainer_step_matches_jax(rng, tmp_path):
    """One clipped Adam step of the perceptron trainer against JAX's, and the
    saved perceptron loads in both packages."""
    from terrain_diffusion_tpu.nn import torch_compat as jcompat
    from terrain_diffusion_tpu.training.trainers.perceptron import PerceptronTrainer as JT

    from terrain_diffusion_tpu_torch.nn import torch_compat
    from terrain_diffusion_tpu_torch.nn.perceptron import PerceptronConfig
    from terrain_diffusion_tpu_torch.training.trainers.perceptron import PerceptronTrainer

    jm, jp, _ = _perceptron_pair()
    config = {"training": {"gradient_clip_val": 0.1}}
    jt = JT(config, {"model": jm, "lr_sched": jls.ConstantLRScheduler(1e-2)})
    jstate = {"params": jp, "opt_state": jt.optimizer.init(jp), "ema": None}
    pt = PerceptronTrainer(config, {"model": ModelSpec(PerceptronConfig.from_dict(
        jm.config.to_dict())), "lr_sched": ls.ConstantLRScheduler(1e-2)}, device="cpu")
    state = pt.init_state(torch.Generator().manual_seed(0))
    pt.model.load_state_dict(params_from_jax(pt.model, jp))
    batch = {"image": rng.standard_normal((8, 4)).astype(np.float32),
             "label": rng.integers(0, 5, 8)}
    jmetrics = jt.train_step(jstate, batch, jax.random.key(1), {"step": 0, "seen": 0})
    metrics = pt.train_step(state, batch, torch.Generator().manual_seed(1),
                            {"step": 0, "seen": 0})
    assert metrics["grad_norm"] > 0.1
    assert _rel(metrics["loss"], jmetrics["loss"]) < TOL and metrics["acc"] == jmetrics["acc"]
    want = params_from_jax(pt.model, jax.tree.map(np.asarray, jstate["params"]))
    for name, p in trained_tensors(pt.model).items():
        assert _rel(p, want[name]) < STEP_TOL, name
    out = str(tmp_path / "perceptron")
    torch_compat.save_model(pt.model, out)
    _jmodel, jparams = jcompat.load_model(out)
    loaded = torch_compat.load_model(out, device="cpu")
    for name, t in params_from_jax(loaded, jparams).items():
        assert torch.equal(t, loaded.state_dict()[name]), name


# ---------------------------------------------------------------------------
# coarse dataset
# ---------------------------------------------------------------------------

def test_fill_oceans_and_area_resize_equal_jax(rng):
    from terrain_diffusion_tpu.training.datasets import coarse_dataset as jc

    from terrain_diffusion_tpu_torch.training.datasets import coarse_dataset as pc

    a = rng.standard_normal((40, 56))
    a[5:30, 10:40] = np.nan
    for kw in ({}, {"tol": 1e-2}, {"multires_factor": 32}):
        np.testing.assert_array_equal(pc.fill_oceans(a, **kw), jc.fill_oceans(a, **kw))
    band = rng.standard_normal((7, 90))
    band[:, 20:25] = np.nan
    np.testing.assert_array_equal(pc._area_resize(band, 41), jc._area_resize(band, 41))


@pytest.fixture(scope="module")
def coarse_tifs(tmp_path_factory):
    """ETOPO-like elevation and four WorldClim-like rasters over the globe
    (1 degree across, 0.5 degree down), ocean climate as nodata."""
    d = tmp_path_factory.mktemp("coarse_src")
    rng = np.random.default_rng(4)
    tf = Affine(1.0, 0.0, -180.0, 0.0, -0.5, 90.0)
    elev = rng.standard_normal((360, 360)) * 2000 + 200
    paths = {"etopo_file": str(d / "etopo.tif")}
    write_geotiff(paths["etopo_file"], elev.astype(np.float32), tf)
    for name in ("mean_temp_file", "std_temp_file", "mean_precip_file", "std_precip_file"):
        c = rng.uniform(0, 30, (360, 360)).astype(np.float32)
        c[elev < 0] = -3.4e38
        paths[name] = str(d / f"{name}.tif")
        write_geotiff(paths[name], c, tf)
    return paths


def test_coarse_dataset_builds_and_gives_jax_items(coarse_tifs, tmp_path):
    import h5py

    from terrain_diffusion_tpu.training.datasets.coarse_dataset import CoarseDataset as JC

    from terrain_diffusion_tpu_torch.training.datasets.coarse_dataset import CoarseDataset

    port = CoarseDataset(str(tmp_path / "port.h5"), **coarse_tifs, crop_size=8, tile_px=2,
                         max_of_n=3)
    ref = JC(str(tmp_path / "jax.h5"), **coarse_tifs, crop_size=8, tile_px=2, max_of_n=3)
    with h5py.File(tmp_path / "port.h5") as a, h5py.File(tmp_path / "jax.h5") as b:
        assert sorted(a) == sorted(b) and len(a) == 9
        for name in a:
            np.testing.assert_array_equal(a[name][()], b[name][()])
        for attr in ("band_weights", "means", "stds"):
            np.testing.assert_array_equal(a.attrs[attr], b.attrs[attr])
    port.set_seed(3)
    ref.set_seed(3)
    for _ in range(8):
        item = port[0]
        assert item["image"].shape == (8, 8, 6) and item["cond_img"].shape == (8, 8, 5)
        _assert_items_equal(item, ref[0])


def test_diffusion_coarse_trains_through_the_cli(coarse_tifs, tmp_path):
    """``train --config diffusion_coarse.cfg --device cpu --max-steps 2`` with
    a tiny model on a coarse.h5 the dataset builds from the GeoTIFFs."""
    from click.testing import CliRunner

    from terrain_diffusion_tpu_torch import __main__ as cli_main

    save_dir = tmp_path / "run"
    overrides = ["model.image_size=8", "model.model_channels=8", "training.batch_size=2",
                 f"logging.save_dir={json.dumps(str(save_dir))}"]
    for section in ("train_dataset", "val_dataset"):
        overrides += [f"{section}.h5_file={json.dumps(str(tmp_path / 'coarse.h5'))}",
                      f"{section}.crop_size=8", f"{section}.tile_px=2"]
        overrides += [f"{section}.{k}={json.dumps(v)}" for k, v in coarse_tifs.items()]
    args = ["train", "--config", os.path.join(ROOT, "configs", "diffusion_coarse",
                                              "diffusion_coarse.cfg"),
            "--device", "cpu", "--max-steps", "2", "--log-every", "1"]
    for ov in overrides:
        args += ["-o", ov]
    res = CliRunner().invoke(cli_main.cli, args)
    assert res.exit_code == 0, res.output
    lines = [json.loads(ln) for ln in open(save_dir / "metrics.jsonl")]
    assert [ln["step"] for ln in lines] == [1, 2]
    assert all(np.isfinite(ln["loss"]) and np.isfinite(ln["grad_norm"]) for ln in lines)


# ---------------------------------------------------------------------------
# biome, file_gan and superres datasets
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def biome_tifs(tmp_path_factory):
    d = tmp_path_factory.mktemp("biome_src")
    rng = np.random.default_rng(6)
    tf = Affine(2.0, 0.0, -180.0, 0.0, -2.0, 90.0)
    paths = {}
    for name in ("temp_file", "temp_std_file", "precip_file", "precip_std_file"):
        c = rng.uniform(-10, 30, (90, 180)).astype(np.float32)
        c[rng.random((90, 180)) < 0.2] = -3.4e38
        paths[name] = str(d / f"{name}.tif")
        write_geotiff(paths[name], c, tf)
    paths["koppen_file"] = str(d / "koppen.tif")
    write_geotiff(paths["koppen_file"], rng.integers(0, 31, (90, 180)).astype(np.uint8), tf)
    return paths


def test_biome_items_equal_jax(biome_tifs):
    from terrain_diffusion_tpu.training.datasets.biome_dataset import BiomeDataset as JB

    from terrain_diffusion_tpu_torch.training.datasets.biome_dataset import BiomeDataset

    kw = dict(biome_tifs, length=64, seed=3, input_dropout=0.25)
    port, ref = BiomeDataset(**kw), JB(**kw)
    np.testing.assert_array_equal(port.x, ref.x)
    np.testing.assert_array_equal(port.y, ref.y)
    for i in (0, 5, 70):
        _assert_items_equal(port[i], ref[i])


def test_file_gan_items_equal_jax(tmp_path):
    from terrain_diffusion_tpu.training.datasets.file_gan_dataset import FileGANDataset as JF

    from terrain_diffusion_tpu_torch.training.datasets.file_gan_dataset import FileGANDataset

    rng = np.random.default_rng(7)
    for i, shape in enumerate([(40, 48), (20, 30)]):  # the second smaller than a crop
        write_geotiff(str(tmp_path / f"t{i}.tif"),
                      (rng.standard_normal(shape) * 500).astype(np.float32), nodata=-9999.0)
    port, ref = FileGANDataset(str(tmp_path), 32), JF(str(tmp_path), 32)
    port.set_seed(5)
    ref.set_seed(5)
    for _ in range(6):
        _assert_items_equal(port[0], ref[0])


def test_superres_items_equal_jax(tmp_path):
    import h5py

    from terrain_diffusion_tpu.training.datasets.superres_dataset import (
        H5SuperresTerrainDataset as JS)

    from terrain_diffusion_tpu_torch.training.datasets.superres_dataset import (
        H5SuperresTerrainDataset)

    path = str(tmp_path / "dataset.h5")
    rng = np.random.default_rng(8)
    with h5py.File(path, "w") as f:
        for sub in range(3):
            d = f.create_group(f"90/0/{sub}").create_dataset(
                "residual", data=rng.standard_normal((48, 40)).astype(np.float32))
            d.attrs["pct_land"] = 0.5
            d.attrs["split"] = "train"
    for eval_dataset in (False, True):
        kw = dict(h5_file=path, crop_size=16, pct_land_ranges=[[0, 1]], subset_resolutions=[90],
                  residual_std=1.3, eval_dataset=eval_dataset)
        port, ref = H5SuperresTerrainDataset(**kw), JS(**kw)
        for _ in range(4):
            _assert_items_equal(port[0], ref[0])


# ---------------------------------------------------------------------------
# GAN
# ---------------------------------------------------------------------------

def test_random_crop_and_linear_warmup():
    from terrain_diffusion_tpu.training.trainers import gan as jgan

    from terrain_diffusion_tpu_torch.training.trainers import gan

    img = np.arange(3 * 16 * 16).reshape(3, 16, 16, 1).astype(np.float32)
    key = jax.random.key(5)
    kh, kw = jax.random.split(key)
    hs, ws = (torch.from_numpy(np.array(jax.random.randint(k, (3,), 0, 5))) for k in (kh, kw))
    want = jgan.random_crop(key, jnp.asarray(img), 12)
    got = gan.random_crop(torch.from_numpy(img), 12, (hs, ws))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert gan.random_crop(torch.from_numpy(img), 16, None).shape == (3, 16, 16, 1)
    for args in ((0.1, 1.0, 0, 4), (0.1, 1.0, 3, 4), (10.0, 1.0, 7, 4), (0.5, 0.2, 2, 0)):
        assert gan.linear_warmup(*args) == jgan.linear_warmup(*args)


def _unet_cfg(in_ch, out_ch):
    return JaxEDMUnetConfig(image_size=16, in_channels=in_ch, out_channels=out_ch,
                            model_channels=8, model_channel_mults=(1,), layers_per_block=1,
                            midblock_attention=False, noise_emb_dims=8, logvar_channels=8)


def _lively(model, seed):
    """Non-zero block gains and out gain: every weight then gets a gradient."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("emb_gain") or name == "out_gain":
                p.copy_(torch.rand((), generator=g) * 0.5 + 0.3)
    return model


def _jax_params(jm, model):
    """JAX's parameter tree of the port's ``model`` (no JAX init to compile)."""
    from terrain_diffusion_tpu.nn import torch_compat as jcompat

    return jcompat.params_from_torch_state(
        jm, {k: v.detach().numpy() for k, v in model.state_dict().items()})


GAN_CONFIG = {
    "training": {"latent_channels": 1, "crop_size": 12, "mode": "inject", "r_gamma": 0.1,
                 "r_interval": 2, "burnin_steps": 4, "kl_weight": 0.01, "range_weight": 1.0,
                 "disc_lr_mult": 2.0, "lr_warmup_factor": 0.1},
    "g_optimizer": {"kwargs": {"betas": [0.0, 0.99]}},
    "d_optimizer": {"kwargs": {"betas": [0.5, 0.99]}},
}


def _gan_pair():
    from terrain_diffusion_tpu.training.trainers.gan import GANTrainer as JG

    from terrain_diffusion_tpu_torch.training.trainers.gan import GANTrainer

    jg, jd = JaxEDMUnet2D(_unet_cfg(2, 1)), JaxEDMUnet2D(_unet_cfg(1, 1))
    jt = JG(GAN_CONFIG, {"model": jg, "discriminator": jd,
                         "lr_sched": jls.ConstantLRScheduler(1e-2)})
    pt = GANTrainer(GAN_CONFIG, {
        "model": ModelSpec(EDMUnetConfig.from_dict(_unet_cfg(2, 1).to_dict())),
        "discriminator": ModelSpec(EDMUnetConfig.from_dict(_unet_cfg(1, 1).to_dict())),
        "lr_sched": ls.ConstantLRScheduler(1e-2)}, device="cpu")
    state = pt.init_state(torch.Generator().manual_seed(0))
    g_params = _jax_params(jg, _lively(pt.model, 1))  # JAX's state on the port's weights
    d_params = _jax_params(jd, _lively(pt.discriminator, 2))
    jstate = {"params": g_params, "d_params": d_params, "opt_state": jt.opt_g.init(g_params),
              "d_opt_state": jt.opt_d.init(d_params), "ema": None}
    return jt, jstate, pt, state


def _jax_gan_draws(key, shape, crop):
    """The port's draws from JAX's step key, split as JAX's GAN step does."""
    b, h, w, c = shape

    def gen(k):
        kz, kt, km, kzi = jax.random.split(k, 4)
        return {"z": jax.random.normal(kz, (b, h, w, 1)), "u": jax.random.uniform(kt, (b,)),
                "u_fixed": jax.random.uniform(km, (b,)),
                "z_img": jax.random.normal(kzi, shape)}

    def offsets(k):
        kh, kw = jax.random.split(k)
        return tuple(jax.random.randint(kk, (b,), 0, n - crop + 1) for kk, n in
                     ((kh, h), (kw, w)))

    def draws(key):
        k1, k2 = jax.random.split(key)
        kg, kc1, kc2 = jax.random.split(k1, 3)
        return {"d_gen": gen(kg), "crop_real": offsets(kc1), "crop_fake": offsets(kc2),
                "g_gen": gen(jax.random.split(k2)[0])}

    return jax.tree.map(lambda a: torch.from_numpy(np.array(a)), jax.jit(draws)(key))


def test_gan_steps_on_jax_draws_match_jax(rng):
    """Step 0 (the R1 penalty, the warmups at their start) and step 1 (no
    penalty) of the GAN trainer in inject mode against JAX's on JAX's draws:
    every loss and grad norm, and both networks' parameters after each step."""
    jt, jstate, pt, state = _gan_pair()
    jcounters, counters = {"step": 0, "seen": 0}, {"step": 0, "seen": 0}
    for step, k in enumerate((31, 32)):
        batch = {"image": rng.standard_normal((2, 16, 16, 1)).astype(np.float32)}
        key = jax.random.key(k)
        jm = jt.train_step(jstate, batch, key, jcounters)
        pt.draw = lambda shape, _g, _k=key: _jax_gan_draws(_k, shape, 12)
        m = pt.train_step(state, batch, None, counters)
        assert (m["r_loss"] > 0) == (jm["r_loss"] > 0) == (step == 0)
        for name in ("d_loss", "g_loss", "kl_loss", "range_loss", "r_loss", "lr"):
            assert abs(m[name] - jm[name]) <= TOL * max(abs(jm[name]), 1e-3), (step, name)
        for name in ("d_grad_norm", "g_grad_norm"):
            assert _rel(m[name], jm[name]) < STEP_TOL, (step, name)
        for model, tree in ((pt.model, jstate["params"]), (pt.discriminator,
                                                           jstate["d_params"])):
            want = params_from_jax(model, jax.tree.map(np.asarray, tree))
            for name, p in trained_tensors(model).items():
                assert _rel(p, want[name]) < STEP_TOL, (step, name, _rel(p, want[name]))
    assert state["d_opt_state"]["count"] == 2


def test_gan_checkpoint_carries_the_discriminator(rng, tmp_path):
    from terrain_diffusion_tpu_torch.training.trainers.gan import GANTrainer

    _jt, _js, pt, state = _gan_pair()
    batch = {"image": rng.standard_normal((2, 16, 16, 1)).astype(np.float32)}
    pt.train_step(state, batch, torch.Generator().manual_seed(1), {"step": 0, "seen": 0})
    fid = pt.evaluate(state, [batch], torch.Generator().manual_seed(2))["val/fid"]
    assert np.isfinite(fid)
    path = str(tmp_path / "ckpt")
    pt.save_checkpoint(state, path, {"step": 1, "seen": 2})
    other = GANTrainer(GAN_CONFIG, pt.resolved, device="cpu")
    state2 = other.init_state(torch.Generator().manual_seed(42))
    assert other.load_checkpoint(state2, path) == {"step": 1, "seen": 2}
    for a, b in ((pt.discriminator, other.discriminator), (pt.model, other.model)):
        for name, t in a.state_dict().items():
            assert torch.equal(t, b.state_dict()[name]), name
    for moment in ("mu", "nu"):
        for name, t in state["d_opt_state"][moment].items():
            assert torch.equal(t, state2["d_opt_state"][moment][name]), name
    assert state2["d_opt_state"]["count"] == 1
    os.remove(os.path.join(path, "gan_state.pt"))
    with pytest.raises(FileNotFoundError, match="discriminator"):
        other.load_checkpoint(state2, path)


# ---------------------------------------------------------------------------
# Inception
# ---------------------------------------------------------------------------

def test_resize_bilinear_no_aa_matches_jax(rng):
    from terrain_diffusion_tpu.evaluation import inception as jinc

    from terrain_diffusion_tpu_torch.evaluation import inception

    for shape, size in (((1, 64, 80, 3), (299, 299)), ((2, 45, 30, 1), (17, 64))):
        x = rng.standard_normal(shape).astype(np.float32)
        want = jinc.resize_bilinear_no_aa(jnp.asarray(x), size)
        got = inception.resize_bilinear_no_aa(torch.from_numpy(x), size)
        assert _rel(got, want) < 1e-6


def test_inception_features_match_jax(rng, tmp_path):
    """Pool3 features of one 299 x 299 image through
    ``resolve_feature_fn("inception:<weights>")`` against JAX's
    ``inception.apply`` on the same random torchvision-named state."""
    from safetensors.numpy import save_file

    from terrain_diffusion_tpu.evaluation import inception as jinc

    from terrain_diffusion_tpu_torch.evaluation.metrics import resolve_feature_fn

    state = jinc.random_torch_state(seed=3)
    path = str(tmp_path / "inception.safetensors")
    save_file(state, path)
    x = rng.uniform(0, 1, (1, 299, 299, 3)).astype(np.float32)
    want = jax.jit(lambda p, xx: jinc.apply(p, jinc.preprocess(xx)))(
        jinc.params_from_torch_state(state), jnp.asarray(x))
    got = resolve_feature_fn(f"inception:{path}")(torch.from_numpy(x))
    assert got.shape == want.shape == (1, 2048)
    assert _rel(got, want) < STEP_TOL
    with pytest.raises(ValueError, match="weights"):
        resolve_feature_fn("inception")


# ---------------------------------------------------------------------------
# the registries
# ---------------------------------------------------------------------------

def _jax_registry_keys():
    from terrain_diffusion_tpu.training import registry as jreg

    jreg.build_registry()
    return [(name, key) for name in ("trainer", "dataset", "model")
            for key in sorted(jreg.REGISTRIES[name]._factories)]


TINY_MODELS = {
    "unet": dict(image_size=8, in_channels=2, model_channels=8, model_channel_mults=[1],
                 layers_per_block=1),
    "autoencoder": dict(image_size=16, in_channels=1, latent_channels=2, model_channels=8,
                        model_channel_mults=[1, 2], layers_per_block=1),
    "perceptron": dict(in_dim=4, out_dim=3, hidden_dims=[8]),
}


@pytest.mark.parametrize("registry,key", _jax_registry_keys())
def test_every_jax_registry_key_resolves(registry, key, tmp_path):
    """Every trainer, dataset and model key the JAX package registers
    resolves in the port to its class: a trainer class, a model spec that
    builds, a dataset that goes as far as reading its (missing) files."""
    from terrain_diffusion_tpu_torch.training import registry as reg
    from terrain_diffusion_tpu_torch.training.trainers.base import TrainerBase

    reg.build_registry()
    factory = reg.REGISTRIES[registry].get(key)
    if registry == "trainer":
        assert issubclass(factory(), TrainerBase)
    elif registry == "model":
        spec = factory(**TINY_MODELS[key])
        model = spec.build("cpu", torch.Generator().manual_seed(0))
        assert type(model).__name__ == {"unet": "EDMUnet2D", "autoencoder": "EDMAutoencoder",
                                        "perceptron": "Perceptron"}[key]
    else:
        missing = str(tmp_path / "missing")
        kwargs = {"coarse": dict(h5_file=missing + ".h5", etopo_file=missing + ".tif"),
                  "biome": dict(temp_file=missing, temp_std_file=missing, precip_file=missing,
                                precip_std_file=missing, koppen_file=missing, length=4),
                  "file_gan": dict(root_dir=missing, crop_size=8)}.get(
            key, dict(h5_file=missing + ".h5", crop_size=8, pct_land_ranges=[[0, 1]],
                      subset_resolutions=[90]))
        if key == "h5_latents":
            kwargs.update(latents_mean=[0] * 4, latents_std=[1] * 4)
        with pytest.raises(OSError):
            factory(**kwargs)
