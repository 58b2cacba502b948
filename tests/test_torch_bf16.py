"""The port's bf16 path against the JAX package's, on the CPU.

The inputs are numpy arrays from a seed, fed to both packages; weights cross
with ``params_from_jax``.  On the JAX side the Pallas kernels run in
interpret mode, as tests/test_pallas_block.py runs them.  On a CPU tensor the
port's kernel wrappers compute their plain versions, which round where the
Pallas kernels round (the card-side kernels are held against those plain
versions in tests/test_torch_cuda_kernels.py).

Bars:
- per kernel, max|diff| / max|ref|: 1e-2 in bf16 and 2.5e-3 in fp16 (about
  2.5 steps of the type at the largest value: both sides round the same
  intermediates and the output, and sum in another order); 1e-5 in float32,
  the existing bar;
- per U-Net and for the pipeline, relative RMSE: port-bf16 against JAX-bf16
  at most 2e-2, and port-bf16 no further from JAX-float32 than twice
  JAX-bf16's own distance to it (the port's bf16 is no worse than the JAX
  package's).
"""
import dataclasses
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from terrain_diffusion_tpu.nn import EDMUnet2D as JaxEDMUnet2D
from terrain_diffusion_tpu.nn import EDMUnetConfig as JaxEDMUnetConfig
from terrain_diffusion_tpu.nn import layers as JL
from terrain_diffusion_tpu.ops import mp as jmp
from terrain_diffusion_tpu.ops import pallas_attention as pa
from terrain_diffusion_tpu.ops import pallas_block as pb
from terrain_diffusion_tpu.pipeline.world import WorldPipeline as JaxWorldPipeline

from terrain_diffusion_tpu_torch import use_full_f32
from terrain_diffusion_tpu_torch.nn.edm_unet import EDMUnet2D, EDMUnetConfig
from terrain_diffusion_tpu_torch.nn.torch_compat import params_from_jax, params_to_jax
from terrain_diffusion_tpu_torch.ops import attention, cuda_lib
from terrain_diffusion_tpu_torch.ops import fused_block as fb
from terrain_diffusion_tpu_torch.pipeline.world import WorldPipeline
from terrain_diffusion_tpu_torch.serving.coalesce import CoalescedPipeline

from helpers import tiny_models

use_full_f32()
KEY = jax.random.key(0)
DTYPES = pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("bfloat16", 1e-2),
                                               ("float16", 2.5e-3)])
RRMSE_BF16 = 2e-2


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
    got = np.asarray(got.detach().float().numpy() if isinstance(got, torch.Tensor) else got,
                     np.float64)
    want = np.asarray(np.asarray(want, np.float32), np.float64)
    return float(np.max(np.abs(got - want)) / (np.max(np.abs(want)) + 1e-12))


def _rrmse(got, want):
    got = np.asarray(got.detach().float().numpy() if isinstance(got, torch.Tensor) else got,
                     np.float64)
    want = np.asarray(np.asarray(want, np.float32), np.float64)
    return float(np.sqrt(np.mean((got - want) ** 2)) / np.sqrt(np.mean(want ** 2)))


def _t(a, dtype=torch.float32):
    return None if a is None else torch.from_numpy(np.array(a, np.float32)).to(dtype)


def _j(a, dtype):
    return None if a is None else jnp.asarray(np.asarray(a, np.float32), getattr(jnp, dtype))


def _norm_scaled(w):
    return jmp.normalize(w) * (1.0 / math.sqrt(int(np.prod(w.shape[:-1]))))


# ---------------------------------------------------------------------------
# per kernel: the plain versions against the Pallas kernels, interpret mode
# ---------------------------------------------------------------------------

BLOCK_CASES = {  # cin, cout, mode, x2 concat, pre-upsample
    "enc": (32, 32, "enc", False, 1),
    "enc_proj": (32, 64, "enc", False, 1),
    "dec_x2_concat": (32, 16, "dec", True, 1),
    "pre_up": (32, 32, "dec", False, 2),
}


@DTYPES
@pytest.mark.parametrize("case", list(BLOCK_CASES))
def test_block_matches_pallas(rng, case, dtype, tol):
    cin, cout, mode, with_x2, preup = BLOCK_CASES[case]
    H, W = (16, 128) if preup == 1 else (8, 64)
    p = JL.unet_block_init(KEY, cin * (2 if with_x2 else 1), cout, 16, mode=mode)
    x = rng.standard_normal((2, H, W, cin)).astype(np.float32)
    x2 = rng.standard_normal((2, H, W, cin)).astype(np.float32) if with_x2 else None
    c = (1.0 + 0.3 * rng.standard_normal((2, cout))).astype(np.float32)
    w0, w1 = _norm_scaled(p["conv_res0"]["w"]), _norm_scaled(p["conv_res1"]["w"])
    wskip = None
    if "conv_skip" in p:
        ws = _norm_scaled(p["conv_skip"]["w"])
        wskip = ws.reshape(ws.shape[2], ws.shape[3])
    kw = dict(mode=mode, pixel_norm=(mode == "enc"), res_balance=0.3, clip_act=256.0,
              concat_scales=(0.7, 0.3) if with_x2 else None, pre_upsample=preup)
    want = pb.fused_block_apply(_j(x, dtype), w0, w1, c, wskip, _j(x2, dtype),
                                interpret=True, **kw)
    tdt = getattr(torch, dtype)
    got = fb.fused_block_reference(_t(x, tdt), _t(w0), _t(w1), _t(c), _t(wskip),
                                   _t(x2, tdt), **kw)
    assert want.dtype == getattr(jnp, dtype) and got.dtype == tdt
    assert got.shape == want.shape
    assert _rel(got, want) < tol


@DTYPES
@pytest.mark.parametrize("cin,cout", [(6, 64), (64, 1)], ids=["in_conv", "head"])
def test_conv3x3_matches_pallas(rng, cin, cout, dtype, tol):
    x = rng.standard_normal((2, 16, 128, cin)).astype(np.float32)
    w = (rng.standard_normal((3, 3, cin, cout)) * (9 * cin) ** -0.5).astype(np.float32)
    want = pb.fused_conv3x3_apply(_j(x, dtype), jnp.asarray(w), interpret=True)
    got = fb.conv3x3_reference(_t(x, getattr(torch, dtype)), _t(w))
    assert got.dtype == getattr(torch, dtype) and got.shape == want.shape
    assert _rel(got, want) < tol


def _pallas_attention(qkv, heads):
    """The Pallas attention kernel body in interpret mode, with its wrapper's
    layout transposes (ops/pallas_attention.py::fused_pixelnorm_attention)."""
    from jax.experimental import pallas as pl

    n, h, w, c3 = qkv.shape
    c = c3 // 3
    ch, hw = c // heads, h * w
    y = jnp.transpose(qkv.reshape(n, hw, heads, ch, 3), (0, 2, 4, 3, 1))
    y = y.reshape(n * heads, 3 * ch, hw)
    out = pl.pallas_call(
        functools.partial(pa._attn_kernel, ch=ch, hw=hw, eps=1e-4),
        out_shape=jax.ShapeDtypeStruct((n * heads, ch, hw), y.dtype),
        grid=(n * heads,),
        in_specs=[pl.BlockSpec((1, 3 * ch, hw), lambda i: (i, 0, 0))],
        out_specs=pl.BlockSpec((1, ch, hw), lambda i: (i, 0, 0)),
        interpret=True,
    )(y)
    return jnp.transpose(out.reshape(n, heads, ch, hw), (0, 3, 1, 2)).reshape(n, h, w, c)


@DTYPES
@pytest.mark.parametrize("shape,heads", [((2, 8, 8, 192), 1), ((2, 8, 8, 2304), 12)],
                         ids=["1x64", "midblock_12x64"])
def test_attention_matches_pallas(rng, shape, heads, dtype, tol):
    qkv = (3.0 * rng.standard_normal(shape)).astype(np.float32)
    want = _pallas_attention(_j(qkv, dtype), heads)
    got = attention.pixelnorm_attention_reference(_t(qkv, getattr(torch, dtype)), heads)
    assert want.dtype == getattr(jnp, dtype) and got.dtype == getattr(torch, dtype)
    assert _rel(got, want) < tol


def test_cpu_wrappers_take_the_bf16_plain_versions(rng):
    """On a CPU tensor each wrapper returns its plain version in bf16 and
    launches nothing."""
    cuda_lib.reset_launch_counts()
    x = _t(rng.standard_normal((1, 8, 16, 16)), torch.bfloat16)
    w = _t(rng.standard_normal((3, 3, 16, 16)) * 0.1)
    assert torch.equal(fb.conv3x3(x, w), fb.conv3x3_reference(x, w))
    assert torch.equal(fb.fused_block(x, w, w, None), fb.fused_block_reference(x, w, w, None))
    qkv = _t(rng.standard_normal((1, 8, 8, 96)), torch.bfloat16)
    got = attention.fused_pixelnorm_attention(qkv, 2)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, attention.pixelnorm_attention_reference(qkv, 2))
    assert (fb.conv3x3.launches, fb.fused_block.launches,
            attention.fused_pixelnorm_attention.launches) == (0, 0, 0)


# ---------------------------------------------------------------------------
# per U-Net, tiny
# ---------------------------------------------------------------------------

def _with_block_kwargs(jmodel, **kw):
    cfg = dataclasses.replace(jmodel.config, block_kwargs={**jmodel.config.block_kwargs, **kw})
    return type(jmodel)(cfg)


def _port(jmodel, jparams):
    model = EDMUnet2D(EDMUnetConfig.from_dict(jmodel.config.to_dict()), device="cpu",
                      generator=torch.Generator().manual_seed(1))
    model.load_state_dict(params_from_jax(model, jparams))
    return model.eval()


def _port_init(jmodel, seed):
    """The port's seeded init of ``jmodel``'s config as JAX's tree (JAX's
    own init compiles one program per weight shape)."""
    cfg = EDMUnetConfig.from_dict(jmodel.config.to_dict())
    return params_to_jax(EDMUnet2D(cfg, device="cpu", generator=torch.Generator().manual_seed(seed)))


def _lively(jparams):
    """Nonzero gains (init leaves them 0, which makes the network constant)."""
    def walk(tree):
        if not isinstance(tree, dict):
            return tree
        return {k: (jnp.asarray(0.4) if k == "emb_gain" else
                    jnp.asarray(1.0) if k == "out_gain" else walk(v))
                for k, v in tree.items()}
    return walk(jparams)


def _unet_bars(jmodel, jparams, x, nl, cond, pallas_model=None):
    """(port-bf16 vs JAX-bf16, port-bf16 vs JAX-f32, JAX-bf16 vs JAX-f32),
    relative RMSE; JAX-bf16 runs ``pallas_model`` when given."""
    want32 = jax.jit(jmodel.apply)(jparams, x, nl, cond)
    want16 = jax.jit((pallas_model or jmodel).apply)(
        jparams, jnp.asarray(x, jnp.bfloat16), jnp.asarray(nl, jnp.bfloat16),
        [jnp.asarray(c, jnp.bfloat16) for c in cond])
    model = _port(jmodel, jparams)
    with torch.no_grad():
        got = model(_t(x, torch.bfloat16), _t(nl, torch.bfloat16),
                    [_t(c, torch.bfloat16) for c in cond])
    assert got.dtype == torch.bfloat16 and want16.dtype == jnp.bfloat16
    return _rrmse(got, want16), _rrmse(got, want32), _rrmse(want16, want32)


def test_decoder_unet_bf16_matches_jax(rng):
    """A decoder-like U-Net with one level at 128x128, where the port routes
    every block (enc, dec with the x2 skip join, midblock) and both 3x3
    convs through the kernels' plain versions and JAX runs them through its
    Pallas kernels (interpret mode).  Measured with these inputs and the
    port's seeded init on the CPU, relative RMSE: port-bf16 vs JAX-bf16
    5.9e-3; vs JAX-f32 port-bf16 7.2e-3, JAX-bf16 6.8e-3."""
    jmodel = JaxEDMUnet2D(JaxEDMUnetConfig(
        image_size=128, in_channels=5, out_channels=1, model_channels=8,
        model_channel_mults=(1,), layers_per_block=1, attn_resolutions=(),
        midblock_attention=False, concat_balance=0.5, conditional_inputs=(),
        fourier_scale="pos", noise_emb_dims=8, logvar_channels=8))
    jparams = _lively(_port_init(jmodel, 5))
    x = rng.standard_normal((1, 128, 128, 5)).astype(np.float32)
    nl = np.full((1,), 0.9, np.float32)
    pallas = _with_block_kwargs(jmodel, block_impl="pallas_interpret")
    vs16, port32, jax32 = _unet_bars(jmodel, jparams, x, nl, [], pallas)
    assert vs16 <= RRMSE_BF16, vs16
    assert port32 <= 2 * jax32, (port32, jax32)


def test_base_unet_bf16_with_attention_matches_jax(rng):
    """A base-like U-Net whose midblock attends (two heads of 16 channels
    on 32x32) with attention_impl="pallas", as the base model's configs ask;
    JAX runs its attention on XLA off the TPU.  Measured with these inputs
    and the port's seeded init on the CPU, relative RMSE: port-bf16 vs
    JAX-bf16 1.21e-2; vs JAX-f32 port-bf16 1.00e-2, JAX-bf16 1.09e-2."""
    jmodel = JaxEDMUnet2D(JaxEDMUnetConfig(
        image_size=64, in_channels=5, out_channels=5, model_channels=16,
        model_channel_mults=(1, 2), layers_per_block=1, attn_resolutions=(),
        midblock_attention=True, concat_balance=0.5,
        conditional_inputs=(("tensor", 58, 1.0),), fourier_scale="pos",
        noise_emb_dims=16, logvar_channels=8,
        block_kwargs={"attention_impl": "pallas", "channels_per_head": 16}))
    jparams = _lively(_port_init(jmodel, 3))
    x = rng.standard_normal((2, 64, 64, 5)).astype(np.float32)
    nl = np.full((2,), 0.9, np.float32)
    cond = [rng.standard_normal((2, 58)).astype(np.float32)]
    model = _port(jmodel, jparams)
    assert sum(getattr(m, "num_heads", 0) for m in model.modules()) == 2
    vs16, port32, jax32 = _unet_bars(jmodel, jparams, x, nl, cond)
    assert vs16 <= RRMSE_BF16, vs16
    assert port32 <= 2 * jax32, (port32, jax32)


# ---------------------------------------------------------------------------
# the pipeline, tiny world
# ---------------------------------------------------------------------------

KW = dict(seed=1234, latents_batch_size=[1, 2, 4], decoder_tile_size=64,
          decoder_tile_stride=48)
QUERY = (0, 0, 24, 24)
# three query boxes, pooled for the pipeline bars: one 24 x 24 box of the
# tiny world covers a handful of coarse and latent cells, so a single box's
# relative RMSE in bf16 is a sample of a few values
QUERIES = (QUERY, (8, -16, 32, 8), (100, 100, 140, 140))


def _port_models(models):
    return [_port(m, p) for m, p in models]


@pytest.fixture(scope="module")
def lively_models():
    return [(m, _lively(p)) for m, p in tiny_models(decoder_tile=64)]


def _pooled(world):
    """{key: the three boxes' values, pooled}, served in one generation pass."""
    outs = world.get_many(QUERIES)
    return {key: np.concatenate([np.ravel(o[key]) for o in outs]) for key in ("elev", "climate")}


@pytest.mark.parametrize("noise_mode", ["portable", "threefry"])
def test_pipeline_bf16_matches_jax(lively_models, noise_mode):
    """Elevation and climate of a bf16 world against the JAX package's bf16
    and float32 worlds, over the three query boxes pooled.  Measured with
    these inputs on the CPU, relative RMSE (portable / threefry): elevation
    port-bf16 vs JAX-bf16 0.0077 / 0.0052; vs JAX-f32 port-bf16 0.0124 /
    0.0085, JAX-bf16 0.0173 / 0.0045; climate port-bf16 vs JAX-bf16 0.0086
    / 0.0069; vs JAX-f32 port-bf16 0.0185 / 0.0101, JAX-bf16 0.0166 /
    0.0154, the same with oneDNN on and off: the port's 16-bit CPU convs and
    matmuls sum in float64 and round once (``ops/nhwc.py``), so no CPU
    instruction set changes a bit, and its MP ops apply their Python
    constants rounded to the type, as the JAX package's weakly typed
    scalars are.  The two packages' bf16 errors are otherwise independent
    (XLA's fusions drop some roundings), so single boxes vary more."""
    kw = dict(KW, noise_mode=noise_mode)
    port = WorldPipeline(device="cpu", dtype="bf16", **kw).set_models(
        *_port_models(lively_models)).bind()
    assert port.compute_dtype == torch.bfloat16
    refs = {}
    for dt in ("bf16", None):
        refs[dt] = JaxWorldPipeline(block_impl="xla", dtype=dt, **kw).set_models(
            *lively_models)
        refs[dt].bind()
    pooled = [_pooled(w) for w in (port, refs["bf16"], refs[None])]
    for key in ("elev", "climate"):
        got, want16, want32 = (p[key] for p in pooled)
        assert np.isfinite(got).all()
        vs16, port32, jax32 = _rrmse(got, want16), _rrmse(got, want32), _rrmse(want16, want32)
        print(f"{noise_mode} {key}: port-bf16 vs JAX-bf16 {vs16:.4f}, vs JAX-f32 "
              f"port-bf16 {port32:.4f} JAX-bf16 {jax32:.4f}")
        assert vs16 <= RRMSE_BF16, (key, vs16)
        assert port32 <= 2 * jax32, (key, port32, jax32)


def test_pipeline_bf16_random_access_is_seed_consistent(lively_models):
    """A bf16 world is seed-consistent random access: every stage window
    read at two alignments, and an overlapping query's climate, agree bit
    for bit on the overlap; a fresh world serving the second query first
    returns the same bytes."""
    models = _port_models(lively_models)
    kw = dict(KW, noise_mode="threefry", dtype="bf16", device="cpu")
    port = WorldPipeline(**kw).set_models(*models).bind()
    a, b = port.get(*QUERY), port.get(8, 8, 32, 32)
    np.testing.assert_array_equal(a["climate"][:, 8:24, 8:24], b["climate"][:, :16, :16])
    for stage, (r1, r2, overlap1, overlap2) in {
            "residual": ([(0, 2), (-24, 40), (8, 56)], [(0, 2), (0, 64), (24, 72)],
                         np.s_[:, 24:, 16:], np.s_[:, :40, :32]),
            "latents": ([(0, 6), (-8, 12), (0, 16)], [(0, 6), (-4, 16), (4, 20)],
                        np.s_[:, 4:, 4:], np.s_[:, :16, :12])}.items():
        with torch.no_grad():
            t1 = getattr(port, stage).read(r1).numpy()
            t2 = getattr(port, stage).read(r2).numpy()
        np.testing.assert_array_equal(t1[overlap1], t2[overlap2])
    fresh = WorldPipeline(**kw).set_models(*models).bind()
    again = fresh.get(8, 8, 32, 32)
    assert again["elev"].tobytes() == b["elev"].tobytes()
    assert again["climate"].tobytes() == b["climate"].tobytes()


@pytest.fixture(scope="module")
def world_dir(lively_models, tmp_path_factory):
    pytest.importorskip("safetensors")
    path = tmp_path_factory.mktemp("world")
    WorldPipeline(device="cpu", **KW).set_models(*_port_models(lively_models)).save_pretrained(
        str(path))
    return str(path)


@pytest.mark.parametrize("server", ["api", "minecraft_api"])
@pytest.mark.parametrize("dtype", ["bf16", "fp16"])
def test_servers_take_dtype(world_dir, monkeypatch, server, dtype):
    """``--dtype bf16`` / ``fp16`` with ``--device cpu`` serves a world in
    that type through each server's entry point."""
    import importlib

    mod = importlib.import_module(f"terrain_diffusion_tpu_torch.serving.{server}")
    monkeypatch.setattr(mod.app, "run", lambda **kw: None)  # configure, load, bind; no socket
    argv = [world_dir, "--device", "cpu", "--dtype", dtype, "--seed", "7",
            "--batch-size", "1,2,4", "--log-mode", "info"]
    try:
        mod.main(argv)
        world = mod._get_pipeline()
        want = torch.bfloat16 if dtype == "bf16" else torch.float16
        assert world.compute_dtype == want and world.device.type == "cpu"
        out = world.get(0, 0, 16, 16)
        assert out["elev"].shape == (16, 16) and np.isfinite(out["elev"]).all()
    finally:
        mod.configure()


def test_fp16_world_is_closer_to_float32_than_bf16(lively_models):
    """An fp16 world (three more significand bits than bf16) serves finite
    terrain no further from the port's float32 world than a bf16 world is,
    over the three query boxes pooled; an unknown dtype raises.  Measured
    with these inputs on the CPU, relative RMSE against float32: elevation
    fp16 0.00030, bf16 0.00607; climate fp16 0.00069, bf16 0.01451."""
    models = _port_models(lively_models)
    worlds = {dt: WorldPipeline(device="cpu", dtype=dt, noise_mode="threefry", **KW).set_models(
        *models).bind() for dt in ("fp32", "bf16", "fp16")}
    assert worlds["fp16"].compute_dtype == torch.float16
    pooled = {dt: _pooled(w) for dt, w in worlds.items()}
    for key in ("elev", "climate"):
        out = {dt: p[key] for dt, p in pooled.items()}
        assert np.isfinite(out["fp16"]).all()
        e16, eb16 = _rrmse(out["fp16"], out["fp32"]), _rrmse(out["bf16"], out["fp32"])
        print(f"{key}: fp16 {e16:.5f} bf16 {eb16:.5f} vs float32")
        assert e16 <= eb16, (key, e16, eb16)
    with pytest.raises(ValueError):
        WorldPipeline(seed=1, device="cpu", dtype="int8")


# ---------------------------------------------------------------------------
# the conditioning mutators
# ---------------------------------------------------------------------------

def _mutated(world):
    world.set_cond_snr([0.5, 0.2, 0.8, 0.2, 0.9])
    values = np.linspace(-200.0, 900.0, 40 * 30, dtype=np.float32).reshape(40, 30)
    world.set_custom_conditioning_import(0, values, -10, 5)
    world.set_custom_conditioning_import(3, np.full((8, 8), 700.0, np.float32), 0, 0,
                                         default_value=400.0)


def test_mutators_match_jax(lively_models):
    """set_cond_snr and set_custom_conditioning_import give the JAX
    package's coarse conditioning and coarse stage, float32 bars."""
    kw = dict(KW, noise_mode="threefry")
    port = WorldPipeline(device="cpu", **kw).set_models(*_port_models(lively_models)).bind()
    ref = JaxWorldPipeline(block_impl="xla", **kw).set_models(*lively_models)
    ref.bind()
    for world in (port, ref):
        _mutated(world)
    assert port.kwargs["cond_snr"] == ref.kwargs["cond_snr"]
    for box in ((-16, 48, 0, 64), (40, 104, 30, 94), (100, 164, 100, 164)):
        np.testing.assert_allclose(port._conditioning_model_input(*box),
                                   ref._conditioning_model_input(*box), rtol=1e-6, atol=1e-6)
    ranges = [(0, 7), (-2, 3), (-1, 3)]
    with torch.no_grad():
        got = port.coarse.read(ranges).numpy()
    want = np.asarray(ref.coarse.read(ranges))
    assert _rrmse(got, want) < 1e-3


def test_mutators_run_through_the_coalescer(lively_models):
    """Through CoalescedPipeline both mutators run solo on the worker and
    the next query sees them: it equals a world mutated directly."""
    kw = dict(KW, noise_mode="threefry", device="cpu")
    models = _port_models(lively_models)
    direct = WorldPipeline(**kw).set_models(*models).bind()
    coalesced = CoalescedPipeline(WorldPipeline(**kw).set_models(*models).bind())
    try:
        for world in (direct, coalesced):
            _mutated(world)
        got, want = coalesced.get(*QUERY), direct.get(*QUERY)
    finally:
        coalesced.close()
    assert coalesced.kwargs["cond_snr"] == [0.5, 0.2, 0.8, 0.2, 0.9]
    assert got["elev"].tobytes() == want["elev"].tobytes()
