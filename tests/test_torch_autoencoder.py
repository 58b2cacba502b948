"""The PyTorch port's VAE (terrain_diffusion_tpu_torch.nn.edm_autoencoder)
against the JAX package's EDMAutoencoder, on the CPU.

Both packages get the same weights (JAX init with nonzero gains, crossed
with params_from_jax) and the same numpy inputs.  Bar: max|diff| / max|ref|
< 1e-4 on the means, logvars, latent samples and reconstructions (float32,
another summation order, compounded over a U-Net encoder and the decoder
stack); the tiled round trip the same.  Checkpoints cross in the reference
layout both ways: the port's save_model is read by the JAX package's
load_model and the JAX package's by the port's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from terrain_diffusion_tpu.evaluation import samplers as jsamplers
from terrain_diffusion_tpu.nn import torch_compat as jcompat
from terrain_diffusion_tpu.nn.edm_autoencoder import EDMAutoencoder as JaxAutoencoder
from terrain_diffusion_tpu.nn.edm_autoencoder import EDMAutoencoderConfig as JaxConfig

from terrain_diffusion_tpu_torch import use_full_f32
from terrain_diffusion_tpu_torch.evaluation.samplers import sample_autoencoder_tiled
from terrain_diffusion_tpu_torch.nn import torch_compat
from terrain_diffusion_tpu_torch.nn.edm_autoencoder import EDMAutoencoder, EDMAutoencoderConfig
from terrain_diffusion_tpu_torch.ops.noise_field import key_from_seed

use_full_f32()
TOL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op torch thread while this module runs: with six pytest-xdist
    workers on the CPU, torch's default of a thread per core makes each small
    op of the tiny models wait on descheduled siblings."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel(got, want):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


def _lively(tree, rng):
    if not isinstance(tree, dict):
        return tree
    return {k: (jnp.asarray(np.float32(rng.standard_normal() * 0.5)) if k == "emb_gain"
                else _lively(v, rng)) for k, v in tree.items()}


def _pair(direct_skips=(), seed=0):
    cfg = JaxConfig(image_size=32, in_channels=2, latent_channels=3, out_channels=2,
                    model_channels=8, model_channel_mults=(1, 2), layers_per_block=1,
                    layers_per_block_decoder=2, midblock_attention=True, logvar_channels=8,
                    direct_skips=direct_skips, block_kwargs={"channels_per_head": 8})
    jm = JaxAutoencoder(cfg)
    pcfg = EDMAutoencoderConfig.from_dict(cfg.to_dict() | {"block_kwargs": cfg.block_kwargs})
    # the port's seeded init as JAX's tree (JAX's own init compiles one
    # program per weight shape), crossing back through params_from_jax
    init = EDMAutoencoder(pcfg, device="cpu", generator=torch.Generator().manual_seed(seed))
    params = _lively(torch_compat.params_to_jax(init), np.random.default_rng(seed))
    params["logvar"] = jnp.asarray([-0.7])
    pm = EDMAutoencoder(pcfg, device="cpu", generator=torch.Generator().manual_seed(seed + 1))
    pm.load_state_dict(torch_compat.params_from_jax(pm, params))
    return jm, params, pm.eval()


@pytest.mark.parametrize("direct_skips", [(), (1,)], ids=["no-skips", "direct-skip"])
def test_autoencoder_matches_jax(rng, direct_skips):
    jm, params, pm = _pair(direct_skips)
    x = rng.standard_normal((2, 32, 32, 2)).astype(np.float32)
    jmeans, jlogvars = jm.preencode(params, x)
    with torch.no_grad():
        means, logvars = pm.preencode(torch.from_numpy(x))
    assert means.shape == jmeans.shape and logvars.shape == jlogvars.shape
    assert _rel(means, jmeans) < TOL and _rel(logvars, jlogvars) < TOL
    z = pm.postencode(means, logvars, key=key_from_seed(4))
    jz = jm.postencode(jmeans, jlogvars, key=jax.random.key(4))
    assert _rel(z, jz) < TOL
    assert pm.postencode(means, logvars) is means  # no key: the means
    jz = np.asarray(jz)
    with torch.no_grad():
        rec, logvar = pm.decode(torch.from_numpy(jz.copy()), include_logvar=True)
    jrec, jlogvar = jm.decode(params, jz, include_logvar=True)
    assert rec.shape == jrec.shape == (2, 32, 32, 2)
    assert _rel(rec, jrec) < TOL
    np.testing.assert_array_equal(logvar.detach().numpy(), np.asarray(jlogvar))
    if direct_skips:  # the skip channel rides through the latent: x's 2x2 means,
        # re-upsampled, plus the sample's noise at std exp(-10)
        pooled = x[..., 1].reshape(2, 16, 2, 16, 2).mean(axis=(2, 4))
        np.testing.assert_allclose(rec[..., 1].numpy(),
                                   np.repeat(np.repeat(pooled, 2, 1), 2, 2), atol=5e-4)


def test_checkpoints_cross_in_the_reference_layout(rng, tmp_path):
    jm, params, pm = _pair((0,), seed=2)
    x = rng.standard_normal((1, 32, 32, 2)).astype(np.float32)
    torch_compat.save_model(pm, str(tmp_path / "port"))
    jm2, jparams2 = jcompat.load_model(str(tmp_path / "port"))  # the JAX package reads it
    assert isinstance(jm2, JaxAutoencoder)
    want = np.asarray(jm.decode(params, jm.preencode(params, x)[0]))
    assert _rel(np.asarray(jm2.decode(jparams2, jm2.preencode(jparams2, x)[0])), want) < 1e-6
    jcompat.save_model(jm, params, str(tmp_path / "jax"))
    for path in ("port", "jax"):
        loaded = torch_compat.load_model(str(tmp_path / path), device="cpu")
        assert isinstance(loaded, EDMAutoencoder) and not loaded.training
        assert loaded.state_dict().keys() == pm.state_dict().keys()
        with torch.no_grad():
            got = loaded.decode(loaded.preencode(torch.from_numpy(x))[0])
        assert _rel(got, want) < TOL


def test_sample_autoencoder_tiled_matches_jax(rng):
    jm, params, pm = _pair()
    x = rng.standard_normal((1, 48, 64, 2)).astype(np.float32)
    kw = dict(tile_size=32, stride=16)
    for key, jkey in ((None, None), (key_from_seed(9), jax.random.key(9))):
        got = sample_autoencoder_tiled(pm, x, key=key, **kw)
        want = jsamplers.sample_autoencoder_tiled(jm, params, x, key=jkey, **kw)
        assert got.shape == x.shape and _rel(got, want) < TOL
