"""The port's row-sharded forward on the CPU, over gloo
(terrain_diffusion_tpu_torch.parallel.spatial): the U-Net of
tests/test_pipeline.py::test_spatial_sharded_decode_matches_single_device
(128 x 128, 16 channels, mults (1, 2), no attention; JAX's weights through
``params_from_jax``), split into bands of rows over 2 and 4 ranks, each band
padded with its neighbours' rows at every 3x3 conv: the gathered output
equals JAX's single-device forward and the port's within 2e-5 (JAX's bar),
and each rank's band is its rows of it.  The same with midblock attention
(the rows all-gathered), against the port's forward.  A height the world
size times 2^(levels - 1) does not divide raises the rule's ValueError;
spatial_model leaves the given model as it is.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dp_helpers as dp
from terrain_diffusion_tpu.nn import EDMUnet2D as JaxEDMUnet2D
from terrain_diffusion_tpu.nn import EDMUnetConfig as JaxEDMUnetConfig

from terrain_diffusion_tpu_torch.nn.edm_unet import EDMUnet2D, EDMUnetConfig
from terrain_diffusion_tpu_torch.nn.torch_compat import params_from_jax
from terrain_diffusion_tpu_torch.parallel import spatial_model
from terrain_diffusion_tpu_torch.parallel.distributed import launch

BAR = dict(rtol=2e-5, atol=2e-5)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op torch thread while this module runs: six pytest-xdist
    workers share the CPU, and torch's default of a thread per core makes
    each small op wait on descheduled siblings."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _config(attention=False):
    return JaxEDMUnetConfig(
        image_size=128, in_channels=3, out_channels=1, model_channels=16,
        model_channel_mults=(1, 2), layers_per_block=1, attn_resolutions=(),
        midblock_attention=attention, conditional_inputs=(), fourier_scale="pos",
        disable_out_gain=True, block_kwargs={"block_impl": "pallas"})


@pytest.fixture(scope="module")
def case():
    jm = JaxEDMUnet2D(_config())
    params = jax.jit(jm.init)(jax.random.key(0))
    x = np.random.default_rng(0).standard_normal((1, 128, 128, 3)).astype(np.float32)
    forward = jax.jit(lambda p, xx: jm.apply(p, xx, jnp.full((1,), 0.8, jnp.float32), []))
    want = np.asarray(forward(params, jnp.asarray(x)))
    pm = EDMUnet2D(EDMUnetConfig.from_dict(_config().to_dict()), device="cpu",
                   generator=torch.Generator().manual_seed(0))
    pm.load_state_dict(params_from_jax(pm, params))
    return pm, torch.from_numpy(x), want


@pytest.mark.parametrize("world", [2, 4])
def test_row_sharded_forward_matches_jax_and_the_port(case, world):
    pm, x, want = case
    nl = torch.full((1,), 0.8)
    with torch.no_grad():
        port = pm(x, nl, []).numpy()
    np.testing.assert_allclose(port, want, **BAR)
    out = launch(dp.spatial_rank, world, pm.config.to_dict(), pm.state_dict(), x, nl)
    h = 128 // world
    for rank, (gathered, band) in enumerate(out):
        np.testing.assert_allclose(gathered.numpy(), want, **BAR)
        np.testing.assert_allclose(gathered.numpy(), port, **BAR)
        assert torch.equal(band, gathered[:, rank * h:(rank + 1) * h])


def test_row_sharded_attention_matches_the_port():
    pm = EDMUnet2D(EDMUnetConfig.from_dict(_config(attention=True).to_dict()), device="cpu",
                   generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        for name, p in pm.named_parameters():
            if name.endswith("emb_gain"):
                p.fill_(0.3)
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (1, 128, 128, 3)).astype(np.float32))
    nl = torch.full((1,), 0.8)
    with torch.no_grad():
        want = pm(x, nl, []).numpy()
    gathered, _ = launch(dp.spatial_rank, 2, pm.config.to_dict(), pm.state_dict(), x, nl)[0]
    np.testing.assert_allclose(gathered.numpy(), want, **BAR)


def test_uneven_height_raises_the_rule(case):
    pm, _, _ = case
    nl = torch.full((1,), 0.8)
    x = torch.zeros((1, 100, 128, 3))  # bands of 25 rows: the 2x2 downsample cuts them
    msgs = launch(dp.spatial_rank, 4, pm.config.to_dict(), pm.state_dict(), x, nl)
    assert all("divides by the world size times 2^(levels - 1) = 4 x 2" in m for m in msgs)
    assert all("got 100" in m for m in msgs)
    sp = spatial_model(pm)
    assert sp is not pm and pm.block_kernels and not sp.block_kernels
    assert type(pm.out_conv).__name__ == "MPConv"
    assert type(sp.out_conv).__name__ == "HaloMPConv"
    assert sp.out_conv.weight is pm.out_conv.weight
