"""The PyTorch port's training math (terrain_diffusion_tpu_torch.training)
against the JAX package's, on the CPU, with tiny U-Nets.

The same weights cross with params_from_jax, the same numpy batches go to
both sides, and the port's losses take JAX's own random draws: the test
splits the step key as ``diffusion_core`` does and hands the standard
normals for sigma and the noise to the port.  Bars, as max|diff| / max|ref|:
- 1e-4 for a training forward and its gradients (whole U-Nets);
- 1e-5 for the diffusion loss and for the parameters after two clipped
  Adam steps (and grad_norm).
The consistency loss is held against JAX in test_torch_training_consistency.py.
Also the dropout formula, and the repair: a training forward (or one that
autograd records through) never reaches a kernel wrapper, and every
wrapper raises where autograd would record.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from terrain_diffusion_tpu.nn import EDMUnet2D as JaxEDMUnet2D
from terrain_diffusion_tpu.nn import EDMUnetConfig as JaxEDMUnetConfig
from terrain_diffusion_tpu.training import diffusion_core as jcore

from terrain_diffusion_tpu_torch import use_full_f32
from terrain_diffusion_tpu_torch.nn import edm_unet, layers
from terrain_diffusion_tpu_torch.nn.edm_unet import EDMUnet2D, EDMUnetConfig
from terrain_diffusion_tpu_torch.nn.layers import UNetBlock, normalize_weights_
from terrain_diffusion_tpu_torch.nn.torch_compat import params_from_jax, params_to_jax
from terrain_diffusion_tpu_torch.ops import attention, fused_block
from terrain_diffusion_tpu_torch.training import diffusion_core as core
from terrain_diffusion_tpu_torch.training.diffusion_core import trained_tensors

use_full_f32()
TOL = 1e-4
LOSS_TOL = 1e-5
STEP_TOL = 1e-5


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
    return float(np.max(np.abs(got - want)) / (np.max(np.abs(want)) + 1e-30))


def _lively(tree):
    """Non-zero gains, so every parameter gets a gradient."""
    if not isinstance(tree, dict):
        return tree
    return {k: (jnp.asarray(0.4) if k == "emb_gain" else
                jnp.asarray(0.8) if k == "out_gain" else _lively(v))
            for k, v in tree.items()}


def _pair(out_ch=1, cond_ch=4, cond_inputs=(), size=16, seed=0, **block_kwargs):
    jcfg = JaxEDMUnetConfig(
        image_size=size, in_channels=out_ch + cond_ch, out_channels=out_ch, model_channels=8,
        model_channel_mults=(1, 2), layers_per_block=1, attn_resolutions=(),
        midblock_attention=False, concat_balance=0.5, conditional_inputs=cond_inputs,
        fourier_scale="pos", noise_emb_dims=8, logvar_channels=8, block_kwargs=block_kwargs)
    jm = JaxEDMUnet2D(jcfg)
    cfg = EDMUnetConfig.from_dict(jcfg.to_dict())
    # the port's seeded init as JAX's tree (JAX's own init compiles one
    # program per weight shape), crossing back through params_from_jax
    jp = _lively(params_to_jax(EDMUnet2D(cfg, device="cpu",
                                         generator=torch.Generator().manual_seed(seed))))
    pm = EDMUnet2D(cfg, device="cpu", generator=torch.Generator().manual_seed(seed + 1))
    pm.load_state_dict(params_from_jax(pm, jp))
    trained_tensors(pm)  # JAX's parameter tree: the Fourier buffers train too
    return jm, jp, pm.train()


def _grads(pm, jax_grads):
    """Port grads (zeros where autograd reached no parameter, as JAX has
    them) and JAX grads (as port state-dict tensors), by name."""
    want = params_from_jax(pm, jax.tree.map(np.asarray, jax_grads))
    return [(k, p.grad if p.grad is not None else torch.zeros_like(p), want[k])
            for k, p in trained_tensors(pm).items()]


def _batch(rng, n, size, out_ch, cond_ch, cond_vec=0):
    b = {"image": rng.standard_normal((n, size, size, out_ch)).astype(np.float32) * 0.5}
    if cond_ch:
        b["cond_img"] = rng.standard_normal((n, size, size, cond_ch)).astype(np.float32)
    if cond_vec:
        b["cond_inputs"] = [rng.standard_normal((n, cond_vec)).astype(np.float32)]
    return b


def _torch_batch(b):
    return {k: ([torch.from_numpy(c) for c in v] if isinstance(v, list) else torch.from_numpy(v))
            for k, v in b.items()}


def _jax_draws(key, shape):
    """The port's draws from JAX's key, as diffusion_core splits it."""
    k_sigma, k_noise, _ = jax.random.split(key, 3)
    return {"sigma_normal": torch.from_numpy(np.array(
                jax.random.normal(k_sigma, (shape[0], 1, 1, 1)))),
            "noise": torch.from_numpy(np.array(jax.random.normal(k_noise, shape))),
            "dropout_seed": 0}


# ---------------------------------------------------------------------------
# the training forward and its gradients
# ---------------------------------------------------------------------------

def test_training_forward_and_gradients_match_jax(rng):
    jm, jp, pm = _pair(out_ch=2, cond_ch=3, cond_inputs=(("tensor", 6, 1.0),))
    x = rng.standard_normal((2, 16, 16, 5)).astype(np.float32)
    nl = np.array([0.3, 1.1], np.float32)
    cond = rng.standard_normal((2, 6)).astype(np.float32)
    wy = rng.standard_normal((2, 16, 16, 2)).astype(np.float32)

    def jloss(p):
        y, lv = jm.apply(p, x, nl, [cond], return_logvar=True, training=True)
        return jnp.sum(y * wy) + jnp.sum(lv * 0.7), (y, lv)

    (_, (want_y, want_lv)), jgrads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(jp)
    y, lv = pm(torch.from_numpy(x), torch.from_numpy(nl), [torch.from_numpy(cond)],
               return_logvar=True, training=True, generator=torch.Generator().manual_seed(1))
    assert _rel(y, want_y) < TOL and _rel(lv, want_lv) < TOL
    (torch.sum(y * torch.from_numpy(wy)) + torch.sum(lv * 0.7)).backward()
    assert all(p.grad is not None for p in trained_tensors(pm).values())
    for name, got, want in _grads(pm, jgrads):
        assert _rel(got, want) < TOL, (name, _rel(got, want))


def test_dropout_formula():
    """Kept values scaled by exactly 1 / (1 - p), the zero fraction within 3
    sigma of p, masks reproducible from the seed, and no dropout in eval."""
    p_drop = 0.3
    block = UNetBlock(16, 16, 8, device="cpu", generator=torch.Generator().manual_seed(0),
                      mode="dec", dropout=p_drop)
    with torch.no_grad():
        block.emb_gain.fill_(0.4)
    seen = []
    real = block.conv_res1.forward
    block.conv_res1.forward = lambda y, gain=1.0: (seen.append(y), real(y, gain))[1]
    g = torch.Generator().manual_seed(2)
    x, emb = torch.randn((4, 16, 16, 16), generator=g), torch.randn((4, 8), generator=g)
    with torch.no_grad():
        eval_out = block(x, emb)
        out_a = block(x, emb, training=True, dropout_seed=11)
        out_b = block(x, emb, training=True, dropout_seed=11)
        block(x, emb, training=False, dropout_seed=11)
    plain, dropped, _, eval_seeded = seen
    assert torch.equal(out_a, out_b)
    assert torch.equal(eval_seeded, plain)
    assert not torch.equal(out_a, eval_out)
    kept = dropped != 0
    assert torch.equal(dropped[kept], plain[kept] / (1.0 - p_drop))
    n = dropped.numel()
    frac = 1.0 - float(kept.float().mean())
    assert abs(frac - p_drop) < 3 * np.sqrt(p_drop * (1 - p_drop) / n)


def test_unet_dropout_seeds_follow_the_plan():
    """One dropout seed a plan entry, drawn from the step generator: the
    same generator seed gives the same forward, another seed another."""
    _, _, pm = _pair(dropout=0.2)
    x = torch.randn((2, 16, 16, 5), generator=torch.Generator().manual_seed(3))
    nl = torch.tensor([0.4, 0.9])

    def run(seed):
        with torch.no_grad():
            return pm(x, nl, training=True, generator=torch.Generator().manual_seed(seed))

    assert torch.equal(run(5), run(5))
    assert not torch.equal(run(5), run(6))
    with torch.no_grad():
        assert torch.equal(pm(x, nl), pm(x, nl, generator=torch.Generator().manual_seed(5)))


# ---------------------------------------------------------------------------
# losses on JAX's draws
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("scale_sigma", [False, True])
def test_diffusion_loss_on_jax_draws(rng, scale_sigma):
    jm, jp, pm = _pair(out_ch=2, cond_ch=3)
    b = _batch(rng, 3, 16, 2, 3)
    cfg = dict(sigma_data=0.5, P_mean=-0.6, P_std=1.3, scale_sigma=scale_sigma,
               scaling_channels=(0, 1) if scale_sigma else ())
    key = jax.random.key(4)
    want, want_aux = jax.jit(lambda p: jcore.diffusion_loss(
        jm, p, b, key, jcore.DiffusionLossConfig(**cfg)))(jp)
    got, aux = core.diffusion_loss(pm, _torch_batch(b), _jax_draws(key, b["image"].shape),
                                   core.DiffusionLossConfig(**cfg))
    assert _rel(got, want) < LOSS_TOL
    assert _rel(aux["sigma_mean"], want_aux["sigma_mean"]) < LOSS_TOL


# ---------------------------------------------------------------------------
# the optimizer and the train step
# ---------------------------------------------------------------------------

def test_two_clipped_train_steps_match_optax(rng):
    """make_train_step with the diffusion loss, two steps with clipping
    active (grad_clip below every step's gradient norm): the parameters
    after each step and grad_norm against JAX's step with optax."""
    jm, jp, pm = _pair(out_ch=2, cond_ch=3)
    clip, lr = 0.05, 2e-3
    jopt = jcore.make_optimizer(betas=(0.9, 0.99), grad_clip=clip)
    lcfg = dict(sigma_data=0.5, P_mean=-0.6, P_std=1.3)
    jstep = jax.jit(jcore.make_train_step(
        lambda p, bb, k: jcore.diffusion_loss(jm, p, bb, k, jcore.DiffusionLossConfig(**lcfg)),
        jopt))
    opt = core.make_optimizer(betas=(0.9, 0.99), grad_clip=clip)
    keys = iter([jax.random.key(21), jax.random.key(22)])
    step = core.make_train_step(
        lambda m, bb, _g: core.diffusion_loss(m, bb, _jax_draws(next(keys), bb["image"].shape),
                                              core.DiffusionLossConfig(**lcfg)), opt)
    jstate, state = jopt.init(jp), opt.init(trained_tensors(pm))
    for k in (21, 22):
        b = _batch(rng, 2, 16, 2, 3)
        jp, jstate, jmetrics = jstep(jp, jstate, b, jax.random.key(k), jnp.float32(lr))
        metrics = step(pm, state, _torch_batch(b), None, lr)
        assert float(jmetrics["grad_norm"]) > clip
        assert _rel(metrics["grad_norm"], jmetrics["grad_norm"]) < STEP_TOL
        assert _rel(metrics["loss"], jmetrics["loss"]) < STEP_TOL
        want = params_from_jax(pm, jax.tree.map(np.asarray, jp))
        for name, p in trained_tensors(pm).items():
            assert _rel(p, want[name]) < STEP_TOL, (k, name, _rel(p, want[name]))
    assert state["count"] == 2


def test_normalize_weights_matches_jax(rng):
    from terrain_diffusion_tpu.nn.layers import norm_weights_tree

    jm, jp, pm = _pair(cond_inputs=(("embedding", 3, 0.5),))
    noisy = jax.tree.map(lambda a: a * 1.7 + 0.01, jp)
    pm.load_state_dict(params_from_jax(pm, noisy))
    normalize_weights_(pm)
    want = params_from_jax(pm, norm_weights_tree(noisy))
    for name, p in pm.named_parameters():
        assert _rel(p, want[name]) < 1e-6, name


# ---------------------------------------------------------------------------
# the repair: no kernel on a path autograd records through
# ---------------------------------------------------------------------------

@pytest.fixture
def raising_kernels(monkeypatch):
    """The U-Net's kernel entry points replaced by functions that raise;
    returns a switch that puts back counting spies instead."""
    calls = []

    def boom(*a, **k):
        raise AssertionError("a kernel wrapper was called")

    for mod, name in ((layers, "fused_block"), (edm_unet, "conv3x3"),
                      (layers, "fused_pixelnorm_attention")):
        monkeypatch.setattr(mod, name, boom)

    def spies():
        for mod, name, real in ((layers, "fused_block", fused_block.fused_block),
                                (edm_unet, "conv3x3", fused_block.conv3x3)):
            monkeypatch.setattr(mod, name, lambda *a, _r=real, _n=name, **k: (
                calls.append(_n), _r(*a, **k))[1])
        return calls
    return spies


def _big_model():
    cfg = EDMUnetConfig(image_size=128, in_channels=2, out_channels=1, model_channels=8,
                        model_channel_mults=(1,), layers_per_block=1, midblock_attention=True,
                        noise_emb_dims=8, logvar_channels=8, fourier_scale="pos",
                        block_kwargs={"channels_per_head": 8, "attention_impl": "pallas"})
    m = EDMUnet2D(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        m.out_gain.fill_(1.0)
    return m


def test_training_forward_at_128_never_calls_a_kernel(raising_kernels):
    m = _big_model().train()
    x = torch.randn((1, 128, 128, 2), generator=torch.Generator().manual_seed(1))
    nl = torch.tensor([0.7])
    y, lv = m(x, nl, return_logvar=True, training=True)
    (y.square().mean() + lv.sum()).backward()
    assert m.enc["128x128_conv"].weight.grad.abs().sum() > 0
    assert m.enc["128x128_block0"].conv_res0.weight.grad.abs().sum() > 0
    m.zero_grad()
    y = m.eval()(x, nl)  # eval mode, but autograd records: the plain path too
    y.square().mean().backward()
    assert m.enc["128x128_block0"].conv_res1.weight.grad.abs().sum() > 0
    xj = x.clone()  # inside torch.func.jvp, even under no_grad
    with torch.no_grad():
        torch.func.jvp(lambda a: m(a, nl), (xj,), (torch.ones_like(xj),))
    calls = raising_kernels()
    with torch.no_grad():
        m(x, nl)
    n_blocks = sum(kind == "block" for _, kind, *_ in m.enc_plan + m.dec_plan)
    assert calls.count("fused_block") == n_blocks == 5 and calls.count("conv3x3") == 2


def test_wrappers_refuse_autograd():
    g = torch.Generator().manual_seed(0)
    x = torch.randn((1, 8, 8, 4), generator=g)
    w0, w1 = torch.randn((3, 3, 4, 4), generator=g), torch.randn((3, 3, 4, 4), generator=g)
    qkv = torch.randn((1, 4, 4, 24), generator=g)
    calls = [lambda a: fused_block.fused_block(a, w0, w1, None, mode="dec"),
             lambda a: fused_block.conv3x3(a, w0),
             lambda a: attention.fused_pixelnorm_attention(a, 2)]
    for fn, inp in zip(calls, (x, x, qkv)):
        with pytest.raises(RuntimeError, match="no backward"):
            fn(inp.clone().requires_grad_())
        with pytest.raises(RuntimeError, match="no backward"):
            torch.func.jvp(fn, (inp,), (torch.ones_like(inp),))
        with torch.no_grad():
            fn(inp.clone().requires_grad_())
        fn(inp)
    with pytest.raises(RuntimeError, match="no backward"):
        fused_block.fused_block(x, w0.clone().requires_grad_(), w1, None, mode="dec")
