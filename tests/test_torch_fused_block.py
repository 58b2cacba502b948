"""The port's plain versions of the two hand-written kernels
(terrain_diffusion_tpu_torch.ops.fused_block) against the JAX Pallas kernels
run in interpreter mode, on the CPU.

Bar: max|diff| / max|ref| < 1e-5, as tests/test_pallas_block.py holds the
Pallas kernel against XLA - float32 with another summation order.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from terrain_diffusion_tpu.nn import layers as JL
from terrain_diffusion_tpu.ops import mp as jmp
from terrain_diffusion_tpu.ops import pallas_block as pb

from terrain_diffusion_tpu_torch import use_full_f32
from terrain_diffusion_tpu_torch.ops import cuda_lib
from terrain_diffusion_tpu_torch.ops import fused_block as fb

use_full_f32()
KEY = jax.random.key(0)
TOL = 1e-5


def _rel(got, want):
    got = got.detach().numpy().astype(np.float64)
    want = np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want)) / (np.max(np.abs(want)) + 1e-12))


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _norm_scaled(w):
    return jmp.normalize(w) * (1.0 / math.sqrt(int(np.prod(w.shape[:-1]))))


def _block_inputs(rng, cin, cout, mode, with_x2, preup):
    H, W = (32, 128) if preup == 1 else (16, 64)
    p = JL.unet_block_init(KEY, cin * (2 if with_x2 else 1), cout, 16, mode=mode)
    p["emb_gain"] = jnp.asarray(0.5)
    x = rng.standard_normal((2, H, W, cin)).astype(np.float32)
    x2 = rng.standard_normal((2, H, W, cin)).astype(np.float32) if with_x2 else None
    emb = rng.standard_normal((2, 16)).astype(np.float32)
    c = JL.mp_conv_apply(p["emb_linear"], emb, gain=p["emb_gain"]) + 1.0
    c = c / jnp.sqrt(jnp.mean(jnp.square(c), axis=-1, keepdims=True) + 1e-8)
    wskip = None
    if "conv_skip" in p:
        ws = _norm_scaled(p["conv_skip"]["w"])
        wskip = ws.reshape(ws.shape[2], ws.shape[3])
    return (x, _norm_scaled(p["conv_res0"]["w"]), _norm_scaled(p["conv_res1"]["w"]),
            c, wskip, x2)


@pytest.mark.parametrize(
    "cin,cout,mode,with_x2,preup,clip",
    [
        (32, 32, "enc", False, 1, 256.0),  # pixel norm + residual
        (32, 64, "enc", False, 1, 256.0),  # 1x1 projection before the norm
        (48, 32, "enc", False, 1, 256.0),
        (32, 32, "dec", False, 1, 256.0),
        (32, 32, "dec", True, 1, 256.0),   # in-kernel skip concat
        (32, 16, "dec", True, 1, 256.0),   # skip concat + dec projection
        (32, 32, "dec", False, 2, 256.0),  # fused nearest x2 upsample
        (32, 32, "dec", False, 1, None),   # attention tail follows: no clip
    ])
def test_fused_block_reference_matches_pallas(rng, cin, cout, mode, with_x2, preup, clip):
    x, w0, w1, c, wskip, x2 = _block_inputs(rng, cin, cout, mode, with_x2, preup)
    kw = dict(mode=mode, pixel_norm=(mode == "enc"), res_balance=0.3, clip_act=clip,
              concat_scales=(0.7, 0.3) if with_x2 else None, pre_upsample=preup)
    want = pb.fused_block_apply(x, w0, w1, c, wskip, x2, interpret=True, **kw)
    got = fb.fused_block_reference(
        _t(x), _t(w0), _t(w1), _t(c), None if wskip is None else _t(wskip),
        None if x2 is None else _t(x2), **kw)
    assert got.shape == want.shape
    assert _rel(got, want) < TOL


@pytest.mark.parametrize("cin,cout,n", [(32, 1, 2), (6, 64, 1), (16, 16, 1)])
def test_conv3x3_reference_matches_pallas(rng, cin, cout, n):
    x = rng.standard_normal((n, 128, 128, cin)).astype(np.float32)
    w = _norm_scaled(jnp.asarray(rng.standard_normal((3, 3, cin, cout)), jnp.float32)) * 0.7
    want = pb.fused_conv3x3_apply(x, w, interpret=True)
    got = fb.conv3x3_reference(_t(x), _t(w))
    assert _rel(got, want) < TOL


def test_cpu_tensors_take_the_plain_version(rng):
    """A wrapper given CPU tensors computes the plain version and launches
    nothing."""
    cuda_lib.reset_launch_counts()
    x, w0, w1, c, wskip, x2 = _block_inputs(rng, 32, 16, "dec", True, 1)
    args = (_t(x), _t(w0), _t(w1), _t(c), _t(wskip), _t(x2))
    kw = dict(mode="dec", pixel_norm=False, res_balance=0.3, clip_act=256.0,
              concat_scales=(0.7, 0.3))
    assert torch.equal(fb.fused_block(*args, **kw), fb.fused_block_reference(*args, **kw))
    xc = _t(rng.standard_normal((1, 16, 24, 8)))
    wc = _t(rng.standard_normal((3, 3, 8, 4)))
    assert torch.equal(fb.conv3x3(xc, wc), fb.conv3x3_reference(xc, wc))
    assert fb.fused_block.launches == 0 and fb.conv3x3.launches == 0


def test_kernel_library_is_named_by_its_sources():
    """The build path hashes every source and header, so an edited kernel
    is rebuilt instead of loading a stale library."""
    path = cuda_lib.library_path()
    assert path.startswith(cuda_lib.BUILD_DIR) and path.endswith(".so")
    assert path == cuda_lib.library_path()
    assert set(cuda_lib._SOURCES) == {"conv3x3.cu", "fused_block.cu", "attention.cu"}
