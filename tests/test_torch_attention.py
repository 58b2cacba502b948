"""The port's pixel-norm attention (ops/attention.py) and the U-Net blocks
that route through it, against the JAX package on the CPU.

The plain twin ``pixelnorm_attention_reference`` is held against the JAX
XLA reference and against the Pallas kernel's body run through
``pl.pallas_call(interpret=True)``, as the JAX package's own test runs it.
On a CPU tensor the kernel wrapper computes the plain twin and launches
nothing; the card-side kernel is tested in tests/test_torch_cuda_kernels.py.

Bars, as max|diff| / max|ref|:
- 1e-5 for the attention core and for one block: float32 with another
  summation order;
- 1e-4 for a whole U-Net, where sum-order drift compounds over depth.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from terrain_diffusion_tpu.nn import EDMUnet2D as JaxEDMUnet2D
from terrain_diffusion_tpu.nn import EDMUnetConfig as JaxEDMUnetConfig
from terrain_diffusion_tpu.nn import layers as JL
from terrain_diffusion_tpu.ops import pallas_attention as pa

from terrain_diffusion_tpu_torch import use_full_f32
from terrain_diffusion_tpu_torch.nn import layers
from terrain_diffusion_tpu_torch.nn.edm_unet import EDMUnet2D, EDMUnetConfig
from terrain_diffusion_tpu_torch.nn.layers import UNetBlock
from terrain_diffusion_tpu_torch.nn.torch_compat import params_from_jax, params_to_jax
from terrain_diffusion_tpu_torch.ops import attention, cuda_lib

use_full_f32()
TOL = 1e-5
UNET_TOL = 1e-4
# (qkv shape with C channels, heads): the JAX test shapes and the base
# model's 12 heads of 64 channels
SHAPES = [((2, 8, 8, 64), 1), ((1, 16, 16, 128), 2), ((2, 8, 8, 768), 12)]


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


def _qkv(rng, shape):
    return rng.standard_normal((*shape[:3], shape[3] * 3)).astype(np.float32)


def _pallas_interpret(qkv, heads):
    """The Pallas kernel body in interpret mode, with the wrapper's layout
    transposes (ops/pallas_attention.py::fused_pixelnorm_attention)."""
    from jax.experimental import pallas as pl

    n, h, w, c3 = qkv.shape
    c = c3 // 3
    ch, hw = c // heads, h * w
    y = jnp.asarray(qkv).reshape(n, hw, heads, ch, 3)
    y = jnp.transpose(y, (0, 2, 4, 3, 1)).reshape(n * heads, 3 * ch, hw)
    out = pl.pallas_call(
        functools.partial(pa._attn_kernel, ch=ch, hw=hw, eps=1e-4),
        out_shape=jax.ShapeDtypeStruct((n * heads, ch, hw), y.dtype),
        grid=(n * heads,),
        in_specs=[pl.BlockSpec((1, 3 * ch, hw), lambda i: (i, 0, 0))],
        out_specs=pl.BlockSpec((1, ch, hw), lambda i: (i, 0, 0)),
        interpret=True,
    )(y)
    out = out.reshape(n, heads, ch, hw)
    return np.asarray(jnp.transpose(out, (0, 3, 1, 2)).reshape(n, h, w, c))


@pytest.mark.parametrize("shape,heads", SHAPES)
def test_reference_matches_jax_reference(rng, shape, heads):
    qkv = _qkv(rng, shape) * 3.0
    want = np.asarray(pa.reference_pixelnorm_attention(jnp.asarray(qkv), heads))
    got = attention.pixelnorm_attention_reference(torch.from_numpy(qkv), heads)
    assert got.shape == want.shape and got.dtype == torch.float32
    assert _rel(got, want) < TOL


@pytest.mark.parametrize("shape,heads", SHAPES)
def test_reference_matches_pallas_kernel_interpret(rng, shape, heads):
    qkv = _qkv(rng, shape)
    want = _pallas_interpret(qkv, heads)
    got = attention.pixelnorm_attention_reference(torch.from_numpy(qkv), heads)
    assert _rel(got, want) < TOL


def test_reference_float64_is_the_float32_math(rng):
    """A float64 input runs the same math in float64 (the card kernel's
    exact oracle); the float32 result agrees with it."""
    qkv = torch.from_numpy(_qkv(rng, (2, 8, 8, 128)))
    got64 = attention.pixelnorm_attention_reference(qkv.double(), 2)
    assert got64.dtype == torch.float64
    assert _rel(attention.pixelnorm_attention_reference(qkv, 2), got64) < TOL


def test_cpu_tensor_takes_the_plain_version(rng):
    cuda_lib.reset_launch_counts()
    qkv = torch.from_numpy(_qkv(rng, (2, 8, 8, 128)))
    assert torch.equal(attention.fused_pixelnorm_attention(qkv, 2),
                       attention.pixelnorm_attention_reference(qkv, 2))
    assert attention.fused_pixelnorm_attention.launches == 0


@pytest.mark.parametrize("shape,heads", [
    ((1, 8, 8, 2304), 12), ((64, 8, 8, 2304), 12), ((1, 32, 64, 576), 3),
    ((1, 64, 64, 192), 1), ((1, 45, 45, 192), 1), ((2, 8, 8, 192), 0),
    ((2, 8, 8, 300), 3), ((1, 40, 50, 96), 2)])
def test_attention_eligible_is_the_jax_rule(shape, heads):
    assert attention.attention_eligible(torch.empty(shape), heads) == \
        pa.attention_eligible(jnp.zeros(shape), heads)


@pytest.mark.parametrize("ch,path", [
    (16, "tensor_cores"), (32, "tensor_cores"), (64, "tensor_cores"),
    (8, "cuda_cores"), (48, "cuda_cores"), (128, "cuda_cores"), (400, "cuda_cores")])
def test_attention_path_rule(ch, path):
    """The widths the tensor-core kernel is built for (16, 32 and 64
    channels per head) take it; every other width takes the CUDA-core
    kernel."""
    assert attention.attention_path(ch) == path


def test_cpu_tensor_needs_no_alignment(rng):
    """The 16-byte alignment the card kernel asks for does not apply to the
    plain version a CPU tensor takes."""
    buf = torch.from_numpy(rng.standard_normal(2 * 8 * 8 * 192 + 1).astype(np.float32))
    qkv = buf[1:].view(2, 8, 8, 192)
    assert qkv.data_ptr() % 16 != 0
    assert torch.equal(attention.fused_pixelnorm_attention(qkv, 1),
                       attention.pixelnorm_attention_reference(qkv.clone(), 1))


def test_base_midblock_is_eligible_at_every_latent_bucket():
    """The shipped base model's midblock attention (64 px latents, the
    deepest level) takes the kernel at every default latent batch bucket:
    the card never falls to the plain version on the serving path."""
    import configparser
    import inspect
    import json
    import os

    from terrain_diffusion_tpu_torch.pipeline.world import WorldPipeline

    cp = configparser.ConfigParser(interpolation=None)
    cp.read(os.path.join(os.path.dirname(__file__), "..", "configs", "diffusion_base",
                         "diffusion_192-3.cfg"))
    model = {k: json.loads(v) for k, v in cp["model"].items() if not k.startswith("@")}
    assert model["midblock_attention"]
    mults = model["model_channel_mults"]
    c = model["model_channels"] * mults[-1]
    heads = c // model["block_kwargs"].get("channels_per_head", 64)
    side = 64 // 2 ** (len(mults) - 1)
    buckets = inspect.signature(WorldPipeline).parameters["latents_batch_size"].default
    assert (side, c, heads) == (8, 768, 12) and max(buckets) == 64
    assert attention.attention_path(c // heads) == "tensor_cores"
    for n in buckets:
        assert attention.attention_eligible(torch.empty((n, side, side, 3 * c)), heads)


def _block_state(p):
    state = {"emb_gain": torch.from_numpy(np.array(p["emb_gain"], np.float32))}
    for name in ("conv_res0", "conv_res1", "conv_skip", "attn_qkv", "attn_proj"):
        if name in p:
            state[f"{name}.weight"] = torch.from_numpy(np.ascontiguousarray(
                np.transpose(np.asarray(p[name]["w"], np.float32), (3, 2, 0, 1))))
    state["emb_linear.weight"] = torch.from_numpy(
        np.ascontiguousarray(np.asarray(p["emb_linear"]["w"], np.float32).T))
    return state


def _count_kernel_calls(monkeypatch):
    calls = []
    real = layers.fused_pixelnorm_attention

    def spy(qkv, num_heads, *a, **k):
        calls.append((tuple(qkv.shape), num_heads))
        return real(qkv, num_heads, *a, **k)

    monkeypatch.setattr(layers, "fused_pixelnorm_attention", spy)
    return calls


@pytest.mark.parametrize("impl", ["pallas", "xla"])
@pytest.mark.parametrize("mode,cin,skip_ch", [("dec", 128, 0), ("enc", 64, 0),
                                               ("dec", 192, 64)])
def test_unet_block_attention_impl(rng, monkeypatch, impl, mode, cin, skip_ch):
    """A block with attention at 8x8, 2 heads of 64 channels, against the
    JAX block with the same attention_impl; "pallas" routes the attention
    core through the kernel wrapper, anything else through the einsum."""
    calls = _count_kernel_calls(monkeypatch)
    cout, emb_ch = 128, 24
    p = JL.unet_block_init(jax.random.key(3), cin, cout, emb_ch, mode=mode, attention=True)
    p["emb_gain"] = jnp.asarray(0.4)
    x = rng.standard_normal((2, 8, 8, cin - skip_ch)).astype(np.float32)
    s = rng.standard_normal((2, 8, 8, skip_ch)).astype(np.float32) if skip_ch else None
    emb = rng.standard_normal((2, emb_ch)).astype(np.float32)
    want = JL.unet_block_apply(p, x, emb, mode=mode, attention=True, skip_input=s,
                               concat_w=0.5, attention_impl=impl)
    block = UNetBlock(cin, cout, emb_ch, device="cpu", generator=torch.Generator(),
                      mode=mode, attention=True, attention_impl=impl)
    block.load_state_dict(_block_state(p))
    with torch.no_grad():
        got = block(torch.from_numpy(x), torch.from_numpy(emb),
                    torch.from_numpy(s) if skip_ch else None, concat_w=0.5)
    assert _rel(got, want) < TOL
    assert calls == ([((2, 8, 8, 3 * cout), 2)] if impl == "pallas" else [])


def test_fused_tail_routes_attention(monkeypatch):
    """The fused-block route's tail (maps of 128 x 128 and up) reaches the
    same attention routing; at 128 x 128 the map is past the kernel's 2048
    pixels, so the eligibility rule sends it to the einsum, as in JAX."""
    calls = _count_kernel_calls(monkeypatch)
    block = UNetBlock(8, 8, 0, device="cpu", generator=torch.Generator().manual_seed(0),
                      mode="dec", attention=True, channels_per_head=4,
                      attention_impl="pallas")
    x = torch.randn((1, 32, 32, 8), generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        tail = block._tail(x)
    assert calls == [((1, 32, 32, 24), 2)]
    assert tail.shape == x.shape
    with torch.no_grad():
        block._tail(torch.zeros((1, 64, 64, 8)))  # HW 4096: not eligible
    assert len(calls) == 1


def test_base_unet_with_midblock_attention_matches_jax(rng, monkeypatch):
    """A narrow base U-Net (64 px latents, midblock attention at 8x8 with
    4 heads) built with attention_impl="pallas", against the JAX model.
    The weights are the port's seeded init, given to JAX through
    ``params_to_jax`` (JAX's own init compiles one program per weight
    shape), and the JAX forward is jitted: one compile, not one per op."""
    calls = _count_kernel_calls(monkeypatch)
    block_kwargs = {"channels_per_head": 8, "attention_impl": "pallas", "dropout": 0.1}
    jcfg = JaxEDMUnetConfig(
        image_size=512, in_channels=5, out_channels=5, model_channels=8,
        model_channel_mults=(1, 2, 3, 4), layers_per_block=1, attn_resolutions=(8, 16),
        midblock_attention=True, concat_balance=0.5,
        conditional_inputs=(("tensor", 58, 1.0),), fourier_scale="pos",
        noise_emb_dims=8, logvar_channels=8, block_kwargs=block_kwargs)
    jmodel = JaxEDMUnet2D(jcfg)
    cfg = EDMUnetConfig.from_dict({**jcfg.to_dict(), "block_kwargs": block_kwargs})
    init = EDMUnet2D(cfg, device="cpu", generator=torch.Generator().manual_seed(5))
    jparams = dict(params_to_jax(init), out_gain=np.float32(0.8))
    x = rng.standard_normal((2, 64, 64, 5)).astype(np.float32)
    cond = rng.standard_normal((2, 58)).astype(np.float32)
    nl = np.full((2,), 0.9, np.float32)
    want = jax.jit(lambda p, x, n, c: jmodel.apply(p, x, n, c))(jparams, x, nl, [cond])
    model = EDMUnet2D(cfg, device="cpu", generator=torch.Generator().manual_seed(1))
    model.load_state_dict(params_from_jax(model, jparams))
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(x), torch.from_numpy(nl),
                           [torch.from_numpy(cond)])
    assert _rel(got, want) < UNET_TOL
    assert calls == [((2, 8, 8, 3 * 32), 4)]  # the midblock 64x64_in0 only
