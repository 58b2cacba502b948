"""Parity of the PyTorch port's U-Net (terrain_diffusion_tpu_torch.nn)
against the JAX package's XLA path, on the CPU.

Weights come from the JAX initializers and cross with params_from_jax;
inputs come from numpy seeds.  Tolerances, as max|diff| / max|ref|:
- 1e-5 for one op or one block: float32 with another summation order;
- 1e-4 for a whole U-Net, where sum-order drift compounds over depth.
"""
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from terrain_diffusion_tpu.nn import layers as JL
from terrain_diffusion_tpu.ops import mp as jmp

from terrain_diffusion_tpu_torch import use_full_f32
from terrain_diffusion_tpu_torch.nn.edm_unet import EDMUnet2D, EDMUnetConfig
from terrain_diffusion_tpu_torch.nn.layers import MPConv, UNetBlock
from terrain_diffusion_tpu_torch.nn.torch_compat import (load_model, params_from_jax,
                                                         save_model)
from terrain_diffusion_tpu_torch.ops import mp

from helpers import tiny_models

use_full_f32()
KEY = jax.random.key(0)
BLOCK_TOL = 1e-5
UNET_TOL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op torch thread while this module runs: six pytest-xdist
    workers share the CPU, and torch's default of a thread per core makes
    each small op wait on descheduled siblings."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel(got, want):
    if isinstance(got, torch.Tensor):
        got = got.detach().numpy()
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want)) / (np.max(np.abs(want)) + 1e-12))


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _port_model(jax_model, jax_params):
    cfg = EDMUnetConfig.from_dict(jax_model.config.to_dict())
    model = EDMUnet2D(cfg, device="cpu", generator=torch.Generator().manual_seed(1))
    model.load_state_dict(params_from_jax(model, jax_params))
    return model.eval()


def _block_state(p):
    """Port state dict of one block from its JAX params."""
    state = {"emb_gain": _t(p["emb_gain"])}
    for name in ("conv_res0", "conv_res1", "conv_skip", "attn_qkv", "attn_proj"):
        if name in p:
            state[f"{name}.weight"] = _t(np.transpose(np.asarray(p[name]["w"]), (3, 2, 0, 1)))
    state["emb_linear.weight"] = _t(np.asarray(p["emb_linear"]["w"]).T)
    return state


def test_mp_ops(rng):
    x = rng.standard_normal((2, 5, 6, 7)).astype(np.float32)
    y = rng.standard_normal((2, 5, 6, 3)).astype(np.float32)
    cases = [
        (mp.normalize(_t(x)), jmp.normalize(x)),
        (mp.normalize(_t(x), dim=-1), jmp.normalize(x, dim=-1)),
        (mp.mp_silu(_t(x)), jmp.mp_silu(x)),
        (mp.mp_sum([_t(x), _t(x[..., ::-1].copy())], w=0.3),
         jmp.mp_sum([x, x[..., ::-1]], w=0.3)),
        (mp.mp_concat([_t(x), _t(y)], dim=-1, w=0.5),
         jmp.mp_concat([x, y], axis=-1, w=0.5)),
        (mp.positional_embedding(_t(x[0, 0, 0]), torch.from_numpy(
            mp.positional_embedding_freqs(8))),
         jmp.positional_embedding(x[0, 0, 0], jmp.positional_embedding_freqs(8))),
    ]
    for got, want in cases:
        assert _rel(got, want) < BLOCK_TOL


@pytest.mark.parametrize("kernel", [(3, 3), (1, 1), ()])
def test_mp_conv(rng, kernel):
    p = JL.mp_conv_init(KEY, 12, 20, list(kernel))
    x = rng.standard_normal((2, 9, 11, 12) if kernel else (3, 12)).astype(np.float32)
    conv = MPConv(12, 20, kernel, device="cpu", generator=torch.Generator())
    w = np.asarray(p["w"])
    conv.weight.data = _t(np.transpose(w, (3, 2, 0, 1)) if kernel else w.T)
    got = conv(_t(x), gain=0.7)
    assert _rel(got, JL.mp_conv_apply(p, x, gain=0.7)) < BLOCK_TOL


@pytest.mark.parametrize(
    "cin,cout,mode,attention,resample_mode,skip_ch,hw",
    [
        (32, 32, "enc", False, "keep", 0, (8, 16)),     # same-C enc
        (32, 64, "enc", False, "keep", 0, (8, 16)),     # 1x1 projection
        (32, 32, "enc", False, "down", 0, (16, 32)),    # strided down
        (32, 32, "dec", False, "keep", 0, (8, 16)),     # same-C dec
        (64, 32, "dec", False, "keep", 32, (8, 16)),    # 2C skip concat
        (64, 64, "dec", True, "keep", 0, (8, 8)),       # attention tail
        (32, 32, "dec", False, "up", 0, (4, 8)),        # nearest up
        # maps of >= 128x128 take the fused-block route (plain version on CPU)
        (16, 16, "enc", False, "keep", 0, (128, 128)),
        (16, 32, "enc", False, "keep", 0, (128, 128)),
        (16, 16, "enc", False, "down", 0, (256, 128)),
        (32, 16, "dec", False, "keep", 16, (128, 128)),  # in-kernel x2 join
        (48, 16, "dec", False, "keep", 32, (128, 128)),  # concat, then block
        (16, 16, "dec", False, "up", 0, (64, 64)),       # in-kernel pre-up
    ])
def test_block_matrix(rng, cin, cout, mode, attention, resample_mode, skip_ch, hw):
    emb_ch = 24
    p = JL.unet_block_init(KEY, cin, cout, emb_ch, mode=mode, attention=attention,
                           resample_mode=resample_mode)
    p["emb_gain"] = jnp.asarray(0.4)  # nonzero: exercise the emb gain
    x = rng.standard_normal((2, *hw, cin - skip_ch)).astype(np.float32)
    s = rng.standard_normal((2, *hw, skip_ch)).astype(np.float32) if skip_ch else None
    emb = rng.standard_normal((2, emb_ch)).astype(np.float32)
    want = JL.unet_block_apply(p, x, emb, mode=mode, attention=attention,
                               resample_mode=resample_mode, skip_input=s,
                               concat_w=0.5)
    block = UNetBlock(cin, cout, emb_ch, device="cpu", generator=torch.Generator(),
                      mode=mode, attention=attention, resample_mode=resample_mode)
    block.load_state_dict(_block_state(p))
    with torch.no_grad():
        got = block(_t(x), _t(emb), _t(s) if skip_ch else None, concat_w=0.5)
    assert got.shape == want.shape
    assert _rel(got, want) < BLOCK_TOL


def _unet_inputs(rng, name, n):
    if name == "coarse":
        x = rng.standard_normal((n, 64, 64, 11)).astype(np.float32)
        cond = [rng.standard_normal((n,)).astype(np.float32) for _ in range(5)]
    elif name == "base":
        x = rng.standard_normal((n, 64, 64, 5)).astype(np.float32)
        cond = [rng.standard_normal((n, 58)).astype(np.float32)]
    else:
        x = rng.standard_normal((n, 128, 128, 5)).astype(np.float32)
        cond = []
    return x, np.full((n,), 0.9, np.float32), cond


@pytest.fixture(scope="module")
def tiny():
    return dict(zip(("coarse", "base", "decoder"), tiny_models()))


@pytest.mark.parametrize("name", ["coarse", "base", "decoder"])
def test_unet_forward(rng, tiny, name):
    jmodel, jparams = tiny[name]
    jparams = dict(jparams, out_gain=jnp.asarray(0.8))  # init is 0: all-zero output
    x, nl, cond = _unet_inputs(rng, name, 2)
    # jitted: one compile of the forward, not one per op
    want, want_lv = jax.jit(lambda p, x, n, c: jmodel.apply(p, x, n, c, return_logvar=True))(
        jparams, x, nl, cond)
    model = _port_model(jmodel, jparams)
    with torch.no_grad():
        got, got_lv = model(_t(x), _t(nl), [_t(c) for c in cond], return_logvar=True)
    assert _rel(got, want) < UNET_TOL
    assert _rel(got_lv, want_lv) < UNET_TOL


def test_base_forward_golden(tiny):
    """The tiny-base forward golden of tests/golden_values.npz, computed by
    the port from the same weights and inputs."""
    from terrain_diffusion_tpu.ops.noise_field import threefry_noise_patch

    golden = np.load(os.path.join(os.path.dirname(__file__), "golden_values.npz"))
    jmodel, jparams = tiny["base"]
    x = np.asarray(threefry_noise_patch(2, 0, 0, h=64, w=64, channels=5,
                                        tile_h=64, tile_w=64))
    x = np.moveaxis(x, 0, -1)[None]
    cond = np.asarray(threefry_noise_patch(3, 0, 0, h=1, w=58, channels=1,
                                           tile_h=1, tile_w=64))[0]
    model = _port_model(jmodel, jparams)
    with torch.no_grad():
        got = model(_t(x), _t([0.7]), [_t(cond)])
    assert _rel(got, golden["base_fwd"]) < UNET_TOL


def test_save_load_roundtrip(tmp_path, tiny):
    pytest.importorskip("safetensors")
    model = _port_model(*tiny["decoder"])
    save_model(model, str(tmp_path / "dec"))
    loaded = load_model(str(tmp_path / "dec"), device="cpu")
    want = model.state_dict()
    for k, v in loaded.state_dict().items():
        assert torch.equal(v, want[k]), k
    assert math.isclose(loaded.config.concat_balance, model.config.concat_balance)
