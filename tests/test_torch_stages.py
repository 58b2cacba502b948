"""Stage math of the PyTorch port against the JAX package, on the CPU:
noise, conditioning, window geometry, the scheduler and the image ops.

Bars:
- bit equality where both sides are exact host arithmetic: portable noise
  streams, tile seeds, Perlin FBm, quantile tables, the synthetic map,
  window geometry, sigma schedules;
- max|diff| / max|ref| < 1e-5 for float32 tensor math (scheduler
  trajectories, image ops, the Laplacian codec): another summation order.
"""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from terrain_diffusion_tpu.ops import image as jimage
from terrain_diffusion_tpu.ops import laplacian as jlap
from terrain_diffusion_tpu.ops import noise_field as jnoise
from terrain_diffusion_tpu.ops import perlin as jperlin
from terrain_diffusion_tpu.ops import rng_portable as jrng
from terrain_diffusion_tpu.ops.windows import linear_weight_window as j_lww
from terrain_diffusion_tpu.pipeline import postprocessing as jpost
from terrain_diffusion_tpu.pipeline import synthetic_map as jsm
from terrain_diffusion_tpu.runtime.window import TensorWindow as JWindow
from terrain_diffusion_tpu import scheduler as jsched
from terrain_diffusion_tpu.scheduler import dpmsolver as jdpm

from terrain_diffusion_tpu_torch import use_full_f32
from terrain_diffusion_tpu_torch.ops import image, laplacian, noise_field, perlin, rng_portable
from terrain_diffusion_tpu_torch.ops.windows import linear_weight_window
from terrain_diffusion_tpu_torch.pipeline import postprocessing, synthetic_map
from terrain_diffusion_tpu_torch.runtime.window import TensorWindow
from terrain_diffusion_tpu_torch.scheduler import dpmsolver

use_full_f32()
TOL = 1e-5


def _rel(got, want):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want)) / (np.max(np.abs(want)) + 1e-12))


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


# --- noise and seeds -------------------------------------------------------

@pytest.mark.parametrize("seed,y0,x0,h,w,ch,tile", [
    (1234, 0, 0, 64, 64, 5, 64), (1235, -70, 33, 64, 96, 6, 64),
    (2 ** 63 + 5, 4096, -512, 40, 24, 1, 32), (7, 0, 0, 512, 512, 1, 512)])
def test_portable_noise_patch_bit_equal(seed, y0, x0, h, w, ch, tile):
    want = jnoise.gaussian_noise_patch(seed, y0, x0, h, w, ch, tile, tile)
    got = noise_field.gaussian_noise_patch(seed, y0, x0, h, w, ch, tile, tile)
    np.testing.assert_array_equal(got, want)


def test_seeds_bit_equal():
    for seed, ty, tx in [(0, 0, 0), (1234, -3, 7), (2 ** 64 - 1, 2 ** 31, -(2 ** 31))]:
        assert rng_portable.tile_seed(seed, ty, tx) == jrng.tile_seed(seed, ty, tx)
    for seed in (1, 1234, 2 ** 63 + 11):
        assert rng_portable.next_seed(seed) == jrng.next_seed(seed)
        np.testing.assert_array_equal(noise_field.seed_to_pair(seed), jnoise.seed_to_pair(seed))
    a = np.empty(10001, np.float32)
    b = np.empty(10001, np.float32)
    rng_portable.fill_standard_normal(99, a)
    jrng.fill_standard_normal(99, b)
    np.testing.assert_array_equal(a, b)


# --- conditioning ----------------------------------------------------------

def test_perlin_fbm_bit_equal(rng):
    xs = rng.uniform(-5000, 5000, 4096).astype(np.float32)
    ys = rng.uniform(-5000, 5000, 4096).astype(np.float32)
    for seed, freq, octaves in [(1, 0.075, 4), (2 ** 40 + 3, 0.15, 2)]:
        np.testing.assert_array_equal(
            perlin.perlin_fbm(seed, freq, octaves, 2.0, 0.5, xs, ys),
            jperlin.perlin_fbm(seed, freq, octaves, 2.0, 0.5, xs, ys))


def test_quantile_tables_and_synthetic_map_bit_equal():
    for freq, octaves in [(0.05 * 1.5, 4), (0.05 * 3, 2)]:
        np.testing.assert_array_equal(synthetic_map._noise_quantiles(freq, octaves, 2.0, 0.5),
                                      jsm._noise_quantiles(freq, octaves, 2.0, 0.5))
    kw = dict(seed=1234, frequency_mult=[1.5, 3, 3, 3, 3], drop_water_pct=0.5)
    got = synthetic_map.make_synthetic_map_factory(**kw)
    want = jsm.make_synthetic_map_factory(**kw)
    for box in [(0, 0, 64, 64), (-48, 96, 16, 160)]:
        np.testing.assert_array_equal(got(*box), want(*box))


# --- window geometry -------------------------------------------------------

@pytest.mark.parametrize("size,stride,offset,ranges", [
    ((6, 64, 64), (6, 32, 32), None, [(0, 6), (-37, 101), (5, 64)]),
    ((7, 4, 4), (7, 1, 1), (0, -1, -1), [(0, 7), (-3, 5), (2, 3)]),
    ((2, 512, 512), (2, 384, 384), None, [(0, 2), (-24, 288), (-24, 288)]),
])
def test_window_geometry_equal(size, stride, offset, ranges):
    got, want = TensorWindow(size, stride, offset), JWindow(size, stride, offset)
    assert got.index_range(ranges) == want.index_range(ranges)
    idxs = list(got.windows_overlapping(ranges))
    assert idxs == list(want.windows_overlapping(ranges))
    assert [got.box(i) for i in idxs] == [want.box(i) for i in idxs]
    np.testing.assert_array_equal(linear_weight_window(size[1]), j_lww(size[1]))


# --- scheduler -------------------------------------------------------------

@pytest.mark.parametrize("order", [1, 2, 3])
def test_sample_dpm_matches_jax(rng, order):
    kw = dict(solver_order=order)
    cfg, jcfg = dpmsolver.EDMSchedulerConfig(**kw), jsched.EDMSchedulerConfig(**kw)
    np.testing.assert_array_equal(dpmsolver.compute_sigmas(cfg, 20),
                                  jsched.compute_sigmas(jcfg, 20))
    assert dpmsolver._order_schedule(cfg, 20) == list(jdpm._order_schedule(jcfg, 20))
    x0 = rng.standard_normal((2, 3, 8, 8)).astype(np.float32) * 80.0
    want = jsched.sample_dpm(lambda x, s: jnp.tanh(x * 1.3) * jnp.cos(s / 40.0),
                             jnp.asarray(x0), jcfg, 20)
    got = dpmsolver.sample_dpm(lambda x, s: torch.tanh(x * 1.3) * float(np.cos(s / 40.0)),
                               _t(x0), cfg, 20)
    assert _rel(got, want) < TOL


def test_dpm_10step_golden():
    golden = np.load(os.path.join(os.path.dirname(__file__), "golden_values.npz"))
    cfg = dpmsolver.EDMSchedulerConfig()
    x0 = np.asarray(jnoise.threefry_noise_patch(
        1, 0, 0, h=8, w=8, channels=1, tile_h=8, tile_w=8)) * float(
            dpmsolver.compute_sigmas(cfg, 10)[0])
    got = dpmsolver.sample_dpm(lambda x, s: torch.tanh(x * 1.3), _t(x0), cfg, 10)
    assert _rel(got, golden["dpm_10step"]) < TOL


def test_trigflow_noise_label():
    for s in (0.002, 0.35, 80.0):
        assert abs(float(dpmsolver.trigflow_precondition_noise(s, 0.5))
                   - float(jsched.trigflow_precondition_noise(jnp.float32(s), 0.5))) < 1e-6


# --- image ops and the Laplacian codec -------------------------------------

@pytest.mark.parametrize("shape,size", [((2, 3, 40, 56), (13, 29)), ((1, 17, 23), (68, 46)),
                                        ((5, 312, 312), (39, 39)), ((5, 39, 39), (312, 312))])
def test_resize_bilinear(rng, shape, size):
    x = rng.standard_normal(shape).astype(np.float32)
    assert _rel(image.resize_bilinear(_t(x), size), jimage.resize_bilinear(x, size)) < TOL


def test_image_ops(rng):
    x = rng.standard_normal((3, 33, 41)).astype(np.float32)
    feats = rng.standard_normal((4, 9, 11)).astype(np.float32)
    grid = rng.uniform(-1.2, 1.2, (16, 20, 2)).astype(np.float32)
    cases = [
        (image.gaussian_blur(_t(x), 11, 5.0), jimage.gaussian_blur(x, 11, 5.0)),
        (image.avg_pool_stride1(_t(x), 15), jimage.avg_pool_stride1(x, 15)),
        (image.upsample_nearest(_t(x), 8), jimage.upsample_nearest(x, 8)),
        (image.avg_pool(_t(x[:, :32, :40]), 4), jimage.avg_pool(x[:, :32, :40], 4)),
        (image.max_pool(_t(x[:, :32, :40]), 4), jimage.max_pool(x[:, :32, :40], 4)),
        (image.min_pool(_t(x[:, :32, :40]), 4), jimage.min_pool(x[:, :32, :40], 4)),
        (image.grid_sample_bilinear(_t(feats), _t(grid)),
         jimage.grid_sample_bilinear(feats, grid)),
        (image.signed_square(_t(x)), jimage.signed_square(x)),
        (image.signed_sqrt(_t(x)), jimage.signed_sqrt(x)),
    ]
    for got, want in cases:
        assert _rel(got, want) < TOL


def test_laplacian_codec(rng):
    x = rng.standard_normal((1, 96, 96)).astype(np.float32) * 30
    low = rng.standard_normal((1, 12, 12)).astype(np.float32) * 30
    for extrapolate in (False, True):
        r, lo = laplacian.laplacian_encode(_t(x), 12, 5.0, extrapolate=extrapolate)
        jr, jlo = jlap.laplacian_encode(x, 12, 5.0, extrapolate=extrapolate)
        assert _rel(r, jr) < TOL and _rel(lo, jlo) < TOL
        assert _rel(laplacian.laplacian_decode(_t(x), _t(low), extrapolate=extrapolate),
                    jlap.laplacian_decode(x, low, extrapolate=extrapolate)) < TOL
    r, lo = laplacian.laplacian_denoise(_t(x), _t(low), sigma=5)
    jr, jlo = jlap.laplacian_denoise(x, low, sigma=5)
    assert _rel(lo, jlo) < TOL


def test_local_baseline_temperature(rng):
    temp = rng.uniform(-10, 30, (40, 44)).astype(np.float32)
    elev = rng.uniform(-500, 3000, (40, 44)).astype(np.float32)
    got = postprocessing.local_baseline_temperature(_t(temp), _t(elev), win=15,
                                                    fallback_threshold=0.02)
    want = jpost.local_baseline_temperature(temp, elev, win=15, fallback_threshold=0.02)
    for g, w in zip(got, want):
        assert _rel(g, w) < TOL


# --- threefry field --------------------------------------------------------
# Bars: the key words and the 32-bit draws are uint32-equal to JAX's; the
# normal values are within 3e-5 of JAX's (the port writes XLA's f32 erf_inv
# polynomial but its own log1p: measured within 5e-7 on a CPU, where
# torch.erfinv would differ by up to 1.5e-5); crops of the port's own field
# agree bit for bit at any alignment.
THREEFRY_TOL = 3e-5


@pytest.mark.parametrize("seed,ty,tx", [
    (0, 0, 0), (1234, -3, 7), (2 ** 64 - 1, 5, -9), (2 ** 40 + 17, 2 ** 20, -1)])
def test_threefry_key_data_and_bits_equal_jax(seed, ty, tx):
    import jax

    key = jnoise._tile_key(seed, ty, tx)
    k1, k2 = noise_field._tile_key(seed, ty, tx)
    want_key = np.asarray(jax.random.key_data(key), np.uint32)
    np.testing.assert_array_equal(np.asarray([int(k1), int(k2)], np.uint32), want_key)
    want_bits = np.asarray(jax.random.bits(key, (3, 5, 7)), np.uint32)
    got_bits = noise_field.random_bits((k1, k2), torch.arange(105)).reshape(3, 5, 7)
    np.testing.assert_array_equal(got_bits.numpy().astype(np.uint32), want_bits)
    # the seed-pair form derives the same key as the python int
    k1p, k2p = noise_field._tile_key(jnoise.seed_to_pair(seed), ty, tx)
    assert (int(k1p), int(k2p)) == (int(k1), int(k2))


@pytest.mark.parametrize("seed,ty,tx", [(99, -1, 0), (2 ** 63 + 5, 7, -3)])
def test_threefry_tile_matches_jax(seed, ty, tx):
    want = np.asarray(jnoise.threefry_tile(seed, ty, tx, 3, 16, 24))
    got = noise_field.threefry_tile(seed, ty, tx, 3, 16, 24)
    assert got.shape == want.shape and got.dtype == torch.float32
    assert float(np.max(np.abs(got.numpy() - want))) < THREEFRY_TOL


@pytest.mark.parametrize("seed,y0,x0,h,w,ch,tile", [
    (1234, 0, 0, 64, 64, 5, 64), (1235, -70, 33, 64, 96, 6, 64),
    (2 ** 63 + 5, 4096, -512, 40, 24, 1, 32), (7, -300, -1000, 512, 512, 1, 512)])
def test_threefry_noise_patch_matches_jax(seed, y0, x0, h, w, ch, tile):
    want = np.asarray(jnoise.threefry_noise_patch(seed, y0, x0, h=h, w=w, channels=ch,
                                                  tile_h=tile, tile_w=tile))
    got = noise_field.threefry_noise_patch(seed, y0, x0, h=h, w=w, channels=ch,
                                           tile_h=tile, tile_w=tile)
    assert got.shape == want.shape and got.dtype == torch.float32
    assert float(np.max(np.abs(got.numpy() - want))) < THREEFRY_TOL


def test_threefry_golden_crop():
    golden = np.load(os.path.join(os.path.dirname(__file__), "golden_values.npz"))
    got = noise_field.threefry_noise_patch(99, -5, 3, h=16, w=16, channels=2,
                                           tile_h=16, tile_w=16)
    assert float(np.max(np.abs(got.numpy() - golden["threefry_16"]))) < THREEFRY_TOL


def test_threefry_crop_alignment_invariance():
    """The field is a pure function of (seed, ty, tx): crops at any
    alignment, negative coordinates included, agree bit for bit, and a
    batch of crops equals the crops drawn one by one."""
    kw = dict(channels=3, tile_h=32, tile_w=32)
    big = noise_field.threefry_noise_patch(42, -50, -70, h=100, w=120, **kw)
    for y0, x0, h, w in [(-50, -70, 100, 120), (-33, -1, 17, 40), (0, 0, 32, 32),
                         (-1, -64, 50, 9), (17, 20, 33, 30)]:
        crop = noise_field.threefry_noise_patch(42, y0, x0, h=h, w=w, **kw)
        assert torch.equal(crop, big[:, y0 + 50:y0 + 50 + h, x0 + 70:x0 + 70 + w])
    y0s, x0s = [-33, 0, 17], [-1, 5, -64]
    batch = noise_field.threefry_noise_batch(42, y0s, x0s, 20, 24, **kw)
    for b, (y0, x0) in enumerate(zip(y0s, x0s)):
        assert torch.equal(batch[b], noise_field.threefry_noise_patch(
            42, y0, x0, h=20, w=24, **kw))


def test_erf_inv_matches_xla():
    """The port's erf_inv is XLA's float32 polynomial: within 3e-5 of
    jax.lax.erf_inv over the whole uniform range normal() draws from, with
    the edge cases (+-1 -> +-inf, 0 -> 0) equal."""
    import jax

    u = torch.linspace(float(np.nextafter(np.float32(-1), np.float32(0))),
                       float(np.nextafter(np.float32(1), np.float32(0))), 400001)
    u = torch.cat([u, torch.tensor([-1.0, 1.0, 0.0, 1e-30, -0.5, 0.999])])
    want = np.asarray(jax.lax.erf_inv(jnp.asarray(u.numpy())))
    got = noise_field.erf_inv_f32(u).numpy()
    finite = np.isfinite(want)
    np.testing.assert_array_equal(got[~finite], want[~finite])
    assert float(np.max(np.abs(got[finite] - want[finite]))) < THREEFRY_TOL


@pytest.mark.parametrize("mode", ["threefry", "portable"])
def test_noise_provider_matches_jax(mode):
    args = (2 ** 33 + 9, -20, 40, 48, 40, 2, 32, 32)
    want = jnoise.NoiseProvider(mode).patch(*args)
    got = noise_field.NoiseProvider(mode).patch(*args)
    assert isinstance(got, np.ndarray) and got.shape == want.shape
    assert float(np.max(np.abs(got - want))) < THREEFRY_TOL
