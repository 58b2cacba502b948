"""The PyTorch port's evaluation path (terrain_diffusion_tpu_torch.evaluation)
against the JAX package's, on the CPU.

Both packages get the same tiny models (tests/helpers.py::tiny_models'
configs, nonzero gains, the port's weights read by the JAX package's
checkpoint loader), the same numpy inputs and the same seed: the port's
threefry keys give JAX's draws.  Bars:
- key split: bit equality with ``jax.random.split``; normals within 5e-7
  (the port's log1p is not XLA's);
- one-forward samplers (consistency, decoder consistency) and
  process_cond_img: max|diff| / max|ref| < 1e-4 (float32, another
  summation order, compounded over a U-Net);
- multi-step DPM samplers (base and decoder diffusion, coarse): relative
  RMSE < 1e-3, the BASELINE.md contract between implementations;
- compose_terrain and terrain_features: max|diff| / max|ref| < 1e-5 (a
  chain of float32 ops); FID and KID on the same features: 1e-6 relative
  (both float64 numpy);
- the latency harness: the same keys as JAX's ``run_latency`` (the port's
  on a tiny world), and the HTTP benchmark through the port's threaded,
  coalesced server answering every request with the full payload.
"""
import jax
import numpy as np
import pytest
import torch

from terrain_diffusion_tpu.evaluation import metrics as jmetrics
from terrain_diffusion_tpu.evaluation import samplers as jsamplers
from terrain_diffusion_tpu.scheduler import dpmsolver as jdpm

from terrain_diffusion_tpu_torch import use_full_f32
from terrain_diffusion_tpu_torch.evaluation import constant_weight_window, tile_starts
from terrain_diffusion_tpu_torch.evaluation import metrics, samplers
from terrain_diffusion_tpu_torch.nn.edm_unet import EDMUnet2D, EDMUnetConfig
from terrain_diffusion_tpu_torch.ops import noise_field as nf
from terrain_diffusion_tpu_torch.scheduler import dpmsolver as dpm

use_full_f32()
ONE_FORWARD_TOL = 1e-4
DPM_TOL = 1e-3
OP_TOL = 1e-5
SEED = 11


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
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) else got
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


def _rrmse(got, want):
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) else got
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.sqrt(np.mean((got - want) ** 2)) / np.sqrt(np.mean(want ** 2)))


# tests/helpers.py::tiny_models' configs (decoder tile 64)
TINY = {
    "coarse": dict(image_size=16, in_channels=11, out_channels=6, model_channels=8,
                   model_channel_mults=(1,), layers_per_block=1, attn_resolutions=(),
                   midblock_attention=False, concat_balance=0.5,
                   conditional_inputs=tuple(("float", 8, 0.2) for _ in range(5)),
                   fourier_scale="pos", noise_emb_dims=8, logvar_channels=8),
    "base": dict(image_size=64, in_channels=5, out_channels=5, model_channels=8,
                 model_channel_mults=(1, 2), layers_per_block=1, attn_resolutions=(),
                 midblock_attention=False, concat_balance=0.5,
                 conditional_inputs=(("tensor", 58, 1.0),), fourier_scale="pos",
                 noise_emb_dims=8, logvar_channels=8),
    "decoder": dict(image_size=64, in_channels=5, out_channels=1, model_channels=8,
                    model_channel_mults=(1, 2), layers_per_block=1, attn_resolutions=(),
                    midblock_attention=False, concat_balance=0.5, conditional_inputs=(),
                    fourier_scale="pos", noise_emb_dims=8, logvar_channels=8),
}


def tiny_pair(cfg: dict, seed: int):
    """(JAX model, JAX params, port model) with the same lively weights: the
    port's seeded init (block gains 0.3, out gain 1, so the networks are not
    constant), read into the JAX tree by the JAX package's own checkpoint
    loader, which spares compiling JAX's init."""
    from terrain_diffusion_tpu.nn import EDMUnet2D as JaxUnet
    from terrain_diffusion_tpu.nn import EDMUnetConfig as JaxConfig
    from terrain_diffusion_tpu.nn.torch_compat import params_from_torch_state

    pm = EDMUnet2D(EDMUnetConfig(**cfg), device="cpu",
                   generator=torch.Generator().manual_seed(seed))
    with torch.no_grad():
        for name, p in pm.named_parameters():
            if name.endswith("emb_gain"):
                p.fill_(0.3)
            elif name == "out_gain":
                p.fill_(1.0)
    jm = JaxUnet(JaxConfig(**cfg))
    params = params_from_torch_state(jm, {k: v.numpy() for k, v in pm.state_dict().items()})
    return jm, params, pm.eval()


@pytest.fixture(scope="module")
def models():
    """{name: (jax model, jax params, port model)} for coarse, base, decoder
    and a second decoder as guide."""
    out = {name: tiny_pair(cfg, seed) for seed, (name, cfg) in enumerate(TINY.items())}
    out["guide"] = tiny_pair(TINY["decoder"], 3)
    return out


@pytest.mark.parametrize("seed,n", [(0, 2), (5, 3), (-7, 4), (2 ** 31 - 1, 5)])
def test_key_split_and_normal_match_jax(seed, n):
    key, jkey = nf.key_from_seed(seed), jax.random.key(seed)
    assert key == tuple(int(v) for v in jax.random.key_data(jkey))
    keys, jkeys = nf.split(key, n), jax.random.split(jkey, n)
    assert keys == [tuple(int(v) for v in k) for k in jax.random.key_data(jkeys)]
    shape = (n, 7, 5, 3)
    got = nf.normal(keys[-1], shape)
    want = np.asarray(jax.random.normal(jkeys[-1], shape))
    assert got.dtype == torch.float32 and got.shape == shape
    assert np.max(np.abs(got.numpy() - want)) < 5e-7


def test_scheduler_helpers_match_jax(rng):
    x = rng.standard_normal((2, 6, 5, 3)).astype(np.float32)
    y = rng.standard_normal((2, 6, 5, 3)).astype(np.float32)
    tx, ty = torch.from_numpy(x), torch.from_numpy(y)
    cfg = dpm.EDMSchedulerConfig()
    assert dpm.init_noise_sigma(cfg) == jdpm.init_noise_sigma(jdpm.EDMSchedulerConfig())
    cases = [(dpm.precondition_inputs(tx, 1.7, 0.5), jdpm.precondition_inputs(x, 1.7, 0.5)),
             (dpm.precondition_noise(torch.tensor(1.7)), jdpm.precondition_noise(1.7)),
             (dpm.add_noise(tx, ty, 0.3), jdpm.add_noise(x, y, 0.3))]
    for pt in ("epsilon", "v_prediction"):
        cases.append((dpm.precondition_outputs(tx, ty, 1.7, 0.5, pt),
                      jdpm.precondition_outputs(x, y, 1.7, 0.5, pt)))
    cases.append((dpm.scale_score_in_velocity(ty, tx, 0.8, ty, alpha=1.4),
                  jdpm.scale_score_in_velocity(y, x, 0.8, y, alpha=1.4)))
    for got, want in cases:
        assert _rel(got, want) < OP_TOL


def test_tiling_helpers_match_jax():
    from terrain_diffusion_tpu import evaluation as jeval

    for total, tile, stride in ((512, 512, 384), (768, 512, 384), (192, 64, 32), (100, 64, 48)):
        assert tile_starts(total, tile, stride) == jeval.tile_starts(total, tile, stride)
    np.testing.assert_array_equal(constant_weight_window(8), jeval.constant_weight_window(8))
    np.testing.assert_array_equal(samplers.linear_weight_window(9),
                                  jeval.linear_weight_window(9))


@pytest.mark.parametrize("denoise,normalized", [(True, True), (False, False)])
def test_compose_terrain_matches_jax(rng, denoise, normalized):
    res = rng.standard_normal((2, 64, 64)).astype(np.float32)
    low = (rng.standard_normal((2, 8, 8)) * (1.0 if normalized else 30.0)).astype(np.float32)
    kw = dict(lowfreq_normalized=normalized, denoise=denoise, residual_std=1.1678)
    assert _rel(samplers.compose_terrain(res, low, **kw),
                jsamplers.compose_terrain(res, low, **kw)) < OP_TOL


def test_terrain_features_and_metrics_match_jax(rng, monkeypatch):
    a = (rng.standard_normal((12, 48, 48, 1)) * 40).astype(np.float32)
    b = (rng.standard_normal((12, 48, 48, 1)) * 30 + np.linspace(0, 50, 48)[None, :, None, None]
         ).astype(np.float32)
    fa = metrics.extract_features(a, batch=6, device="cpu")
    fb = metrics.extract_features(b, batch=6, device="cpu")
    ja, jb = jmetrics.extract_features(a, batch=6), jmetrics.extract_features(b, batch=6)
    assert fa.shape == ja.shape and _rel(fa, ja) < OP_TOL and _rel(fb, jb) < OP_TOL
    fid, jfid = metrics.frechet_distance(fa, fb), jmetrics.frechet_distance(fa, fb)
    assert abs(fid - jfid) <= 1e-6 * abs(jfid)
    for got, want in zip(metrics.kid(fa, fb, n_subsets=20), jmetrics.kid(fa, fb, n_subsets=20)):
        assert abs(got - want) <= 1e-6 * abs(want)
    img = (rng.standard_normal((3, 8, 8, 1)) * 400).astype(np.float32)
    np.testing.assert_array_equal(metrics.normalize_terrain_for_metric(img),
                                  jmetrics.normalize_terrain_for_metric(img))
    fid, kid_m, _ = metrics.compute_fid_kid(a, b, batch=6, device="cpu", n_subsets=10)
    jfid, jkid_m, _ = jmetrics.compute_fid_kid(a, b, batch=6, n_subsets=10)
    assert abs(fid - jfid) <= 1e-4 * abs(jfid) and abs(kid_m - jkid_m) <= 1e-4 * abs(jkid_m)
    monkeypatch.delenv("TDTPU_INCEPTION_WEIGHTS", raising=False)
    with pytest.raises(ValueError, match="weights file"):  # "inception:<path>" names it
        metrics.resolve_feature_fn("inception")


def _cond_img(rng, b, n):
    c = rng.standard_normal((b, 7, n, n)).astype(np.float32)
    c[:, 0, 0, 1] = np.nan  # NaN fill: cond_means[0] in normalized space
    return c


def test_process_cond_img_matches_jax(rng):
    cond = _cond_img(rng, 3, 4)
    means, stds = rng.standard_normal(7), rng.random(7) + 0.5
    hist = rng.standard_normal(5)
    got = samplers.process_cond_img(cond, hist, means, stds, noise_level=0.3)
    want = jsamplers.process_cond_img(cond, hist, means, stds, noise_level=0.3)
    assert got.shape == (3, 58) and _rel(got, want) < OP_TOL
    vals, t = samplers.cond_inputs_from_snr([0.3, 0.1, 1.0, 0.1, 1.0], batch=2)
    jvals, jt = jsamplers.cond_inputs_from_snr([0.3, 0.1, 1.0, 0.1, 1.0], batch=2)
    np.testing.assert_array_equal(t, jt)
    for v, jv in zip(vals, jvals):
        np.testing.assert_array_equal(v.numpy(), np.asarray(jv))


@pytest.mark.parametrize("tiled", [False, True])
def test_sample_base_consistency_matches_jax(models, rng, tiled):
    m, p, pm = models["base"]
    key, jkey = nf.key_from_seed(SEED), jax.random.key(SEED)
    if tiled:
        cond = _cond_img(rng, 1, 5)
        kw = dict(tile_size=64, cond_means=np.zeros(7), cond_stds=np.ones(7),
                  histogram_raw=np.zeros(5), skip_blend_last=True)
        shape = (1, 96, 96, 5)
    else:
        cond, kw, shape = [rng.standard_normal((2, 58)).astype(np.float32)], {}, (2, 64, 64, 5)
    got = samplers.sample_base_consistency(pm, shape, cond, key=key, inter_t=1.1, **kw)
    want = jsamplers.sample_base_consistency(m, p, shape, cond, key=jkey, inter_t=1.1, **kw)
    assert got.shape == shape and _rel(got, want) < ONE_FORWARD_TOL


@pytest.mark.parametrize("tiled", [False, True])
def test_sample_base_diffusion_matches_jax(models, rng, tiled):
    m, p, pm = models["base"]
    key, jkey = nf.key_from_seed(SEED + 1), jax.random.key(SEED + 1)
    if tiled:
        cond = _cond_img(rng, 1, 5)
        kw = dict(tile_size=64, cond_means=np.zeros(7), cond_stds=np.ones(7),
                  histogram_raw=rng.standard_normal(5), noise_level=0.2)
        shape = (1, 96, 64, 5)
    else:
        cond, kw, shape = [rng.standard_normal((2, 58)).astype(np.float32)], {}, (2, 64, 64, 5)
    got = samplers.sample_base_diffusion(pm, shape, cond, key=key, steps=4, **kw)
    want = jsamplers.sample_base_diffusion(m, p, shape, cond, key=jkey, steps=4, **kw)
    assert got.shape == shape and _rrmse(got, want) < DPM_TOL


def test_sample_decoder_consistency_tiled_matches_jax(models, rng):
    m, p, pm = models["decoder"]
    lat = rng.standard_normal((1, 12, 12, 4)).astype(np.float32)
    kw = dict(tile_size=64, stride=48)
    got = samplers.sample_decoder_consistency_tiled(pm, lat, key=nf.key_from_seed(SEED), **kw)
    want = jsamplers.sample_decoder_consistency_tiled(m, p, lat, key=jax.random.key(SEED), **kw)
    assert got.shape == (1, 96, 96, 1) and _rel(got, want) < ONE_FORWARD_TOL


@pytest.mark.parametrize("guided", [False, True])
def test_sample_decoder_diffusion_tiled_matches_jax(models, rng, guided):
    m, p, pm = models["decoder"]
    g, gp, gm = models["guide"]
    lat = rng.standard_normal((1, 10, 8, 4)).astype(np.float32)
    kw = dict(tile_size=64, stride=48, steps=3)
    if guided:
        kw.update(guidance_scale=1.5, score_scaling=1.3)
    got = samplers.sample_decoder_diffusion_tiled(pm, lat, key=nf.key_from_seed(SEED),
                                                  guide_model=gm if guided else None, **kw)
    want = jsamplers.sample_decoder_diffusion_tiled(m, p, lat, key=jax.random.key(SEED),
                                                    guide_model=g if guided else None,
                                                    guide_params=gp if guided else None, **kw)
    assert got.shape == (1, 80, 64, 1) and _rrmse(got, want) < DPM_TOL


def test_sample_coarse_tiled_matches_jax(models, rng):
    m, p, pm = models["coarse"]
    cond = rng.standard_normal((1, 48, 48, 5)).astype(np.float32)
    snr = [0.3, 0.1, 1.0, 0.1, 1.0]
    kw = dict(steps=3, tile_size=32)
    got = samplers.sample_coarse_tiled(pm, cond, snr, key=nf.key_from_seed(SEED), **kw)
    want = jsamplers.sample_coarse_tiled(m, p, cond, snr, key=jax.random.key(SEED), **kw)
    assert got.shape == (1, 48, 48, 6) and _rrmse(got, want) < DPM_TOL


def _port_world(models):
    from terrain_diffusion_tpu_torch.pipeline.world import WorldPipeline

    world = WorldPipeline(device="cpu", seed=77, latents_batch_size=[1, 2, 4],
                          decoder_tile_size=64, decoder_tile_stride=48)
    return world.set_models(*(models[n][2] for n in ("coarse", "base", "decoder"))).bind()


def _keys(d):
    return {k: _keys(v) if isinstance(v, dict) else None for k, v in d.items()}


class _StubWorld:
    """What JAX's ``run_latency`` calls on a world (its result's keys do not
    depend on the world's output, and a stub spares compiling a JAX world)."""

    def get(self, *box, with_climate=False):
        return {}

    def empty_cache(self):
        pass


def test_run_latency_keys_match_jax(models):
    from terrain_diffusion_tpu.evaluation.latency import run_latency as jax_run_latency

    from terrain_diffusion_tpu_torch.evaluation.latency import run_latency

    port = _port_world(models)
    want = jax_run_latency(_StubWorld(), n_runs=1, tile=16, separation=64)
    for aligned in (False, True):
        got = run_latency(port, n_runs=1, tile=16, separation=64, grid_aligned=aligned)
        assert _keys(got) == _keys(want)
        assert all(got[k]["p50"] > 0 for k in ("ttft", "ttst"))
        assert got["memory"]["platform"] == "cpu" and got["grid_aligned"] is aligned


def test_http_benchmark_real_sockets(models):
    """The requests/s benchmark through the port's own stack: the threaded
    WSGI server on a live socket, the coalesced pipeline, binary wire
    answers of the full size, at 1 and 2 concurrent clients."""
    from terrain_diffusion_tpu_torch.evaluation.latency import run_http_benchmark

    port = _port_world(models)
    out = run_http_benchmark(port, concurrency_levels=(1, 2), requests_per_client=2, tile=24)
    assert out["coalesce"] is True and set(out["levels"]) == {"1", "2"}
    for c, lvl in out["levels"].items():
        assert lvl["requests"] == int(c) * 2
        assert lvl["requests_per_sec"] > 0 and lvl["latency_p50_s"] > 0
    assert port.tile_store is not None  # the caller's world stays open


def test_latency_cli_refuses_a_missing_card(tmp_path):
    from click.testing import CliRunner

    from terrain_diffusion_tpu_torch.evaluation.latency import main

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    result = CliRunner().invoke(main, [str(tmp_path), "--runs", "1"])
    assert result.exit_code != 0 and "--device cpu" in result.output


def test_latency_cli_on_a_saved_world(models, tmp_path):
    """``main`` as the card runs it (``standalone_mode=False`` returns the
    result), on a tiny world saved in the reference layout, ``--device cpu``."""
    from terrain_diffusion_tpu_torch.evaluation.latency import main
    from terrain_diffusion_tpu_torch.pipeline.world import WorldPipeline

    world = WorldPipeline(device="cpu", decoder_tile_size=64, decoder_tile_stride=48)
    world.set_models(*(models[n][2] for n in ("coarse", "base", "decoder")))
    world.save_pretrained(str(tmp_path))
    out = main.main(args=[str(tmp_path), "--runs", "1", "--tile", "16", "--batch-size", "1,2,4",
                          "--dtype", "fp32", "--device", "cpu", "--grid-aligned"],
                    standalone_mode=False)
    assert out["n_runs"] == 1 and out["grid_aligned"] and out["ttft"]["p50"] > 0
