"""The port's sCM/TrigFlow consistency loss
(terrain_diffusion_tpu_torch.training.diffusion_core.consistency_loss)
against the JAX package's, on the CPU, with tiny U-Nets and JAX's own random
draws: F_theta, its JVP tangent F_theta_grad, the loss and the student's
gradients, bar 1e-4 as max|diff| / max|ref| (whole U-Nets, forward-mode
included).  Cases: with and without an AutoGuidance guide, loss_groups set
and not, use_logvar both ways, and the warmup ratio r below 1 and at 1.
"""
import dataclasses

import jax
import jax.numpy as jnp
import pytest

from terrain_diffusion_tpu.training import diffusion_core as jcore

from terrain_diffusion_tpu_torch.training import diffusion_core as core

from test_torch_training_core import TOL, _batch, _grads, _jax_draws, _pair, _rel, _torch_batch


def _jax_terms(jm, jp, teacher, guide, b, key, cfg):
    """F_theta and its tangent F_theta_grad as JAX's consistency_loss makes
    them (its first half, on the same key)."""
    images, cond_img, sd = b["image"], b.get("cond_img"), cfg.sigma_data
    k_sigma, k_noise, _ = jax.random.split(key, 3)
    sigma = jnp.exp(jax.random.normal(k_sigma, (images.shape[0], 1, 1, 1)) * cfg.P_std
                    + cfg.P_mean)
    t = jnp.arctan(sigma / sd)
    x_t = jnp.cos(t) * images + jnp.sin(t) * jax.random.normal(k_noise, images.shape) * sd

    def cat(z):
        return jnp.concatenate([z, cond_img], axis=-1) if cond_img is not None else z

    m_pred = teacher(cat(x_t / sd), t.reshape(-1), None)
    pred = m_pred if guide is None else guide(cat(x_t / sd), t.reshape(-1), None) + \
        cfg.guidance_scale * (m_pred - guide(cat(x_t / sd), t.reshape(-1), None))
    dxt_dt = sd * -pred

    def wrapper(xs, t_in):
        out, lv = jm.apply(jp, cat(xs), t_in.reshape(-1), None, return_logvar=True,
                           training=True)
        return -out, lv

    (f, _), (f_grad, _) = jax.jvp(wrapper, (x_t / sd, t),
                                  (jnp.cos(t) * jnp.sin(t) * dxt_dt / sd, jnp.cos(t) * jnp.sin(t)))
    return f, f_grad


CONSISTENCY_CASES = [  # (guide, loss_groups, use_logvar, step): r < 1 at step 0, r = 1 at 9
    (True, None, True, 0),
    (False, (2, 1), False, 9),
    (True, (2, 1), True, 9),
]


@pytest.mark.parametrize("with_guide,groups,use_logvar,step", CONSISTENCY_CASES)
def test_consistency_loss_on_jax_draws(rng, with_guide, groups, use_logvar, step):
    jm, jp, pm = _pair(out_ch=3, cond_ch=2, seed=1)
    jt, jtp, tm = _pair(out_ch=3, cond_ch=2, seed=2)
    jg, jgp, gm = _pair(out_ch=3, cond_ch=2, seed=3)
    cfg = jcore.ConsistencyLossConfig(sigma_data=0.5, P_mean=-0.6, P_std=2.0,
                                      guidance_scale=1.265, warmup_steps=10,
                                      loss_groups=groups, use_logvar=use_logvar, const_c=0.1)
    b = _batch(rng, 2, 16, 3, 2)
    key = jax.random.key(7 + step)

    def teacher(x, c, ci):
        return jax.lax.stop_gradient(jt.apply(jtp, x, c, ci))

    def guide(x, c, ci):
        return jax.lax.stop_gradient(jg.apply(jgp, x, c, ci))

    guide = guide if with_guide else None
    jfn = lambda p: jcore.consistency_loss(jm, p, teacher, b, key, cfg, step,  # noqa: E731
                                           guide_apply=guide)
    (want, _), jgrads = jax.jit(jax.value_and_grad(jfn, has_aux=True))(jp)
    want_f, want_fg = jax.jit(lambda p: _jax_terms(jm, p, teacher, guide, b, key, cfg))(jp)

    tm.eval(), gm.eval()
    loss, aux = core.consistency_loss(
        pm, tm, _torch_batch(b), _jax_draws(key, b["image"].shape),
        core.ConsistencyLossConfig(**dataclasses.asdict(cfg)), step,
        guide_fn=gm if with_guide else None, return_terms=True)
    assert _rel(aux["F_theta"], want_f) < TOL
    assert _rel(aux["F_theta_grad"], want_fg) < TOL
    assert _rel(loss.detach(), want) < TOL
    loss.backward()
    for name, got, want_g in _grads(pm, jgrads):
        assert _rel(got, want_g) < TOL, (name, _rel(got, want_g))
    assert all(p.grad is None for p in tm.parameters())
