"""The port's remaining host pieces against the JAX package's, on the CPU:
the ``sde-dpmsolver++`` sampler, the hydrology tools and the native host
library.

- ``sample_dpm`` with ``sde-dpmsolver++`` on the same model function,
  config and ``sde_noise`` as JAX's ``lax.scan``: orders 1 and 2, both
  solver types, max|diff| / max|ref| < 1e-5 (float32, the same scalar
  coefficients); JAX's two errors; the ODE path unchanged by the noise.
- ``d8_flow``, ``flow_accumulation``, ``priority_flood_fill``,
  ``river_bump_smooth`` on seeded terrain: equal to JAX's bit for bit (the
  same numpy and heapq code).
- ``terrain_diffusion_tpu_torch.native``: the port's own build of the C++
  sources gives JAX's numpy paths bit for bit (Perlin FBm, the portable
  normal stream, the tiled portable field); every Perlin config the port
  uses has octave weights that round alike in both paths; importing it
  never runs a compiler; ``TDTPU_DISABLE_NATIVE`` and a stale library load as None; a
  failed build is cached.
"""
import importlib
import os
import re
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from terrain_diffusion_tpu.ops import perlin as jax_perlin
from terrain_diffusion_tpu.ops import rng_portable as jax_rng
from terrain_diffusion_tpu.pipeline import postprocessing as jax_post
from terrain_diffusion_tpu.scheduler import dpmsolver as jdpm

from terrain_diffusion_tpu_torch import native
from terrain_diffusion_tpu_torch.ops import noise_field, perlin, rng_portable
from terrain_diffusion_tpu_torch.pipeline import postprocessing as post
from terrain_diffusion_tpu_torch.scheduler import dpmsolver as dpm

SDE_TOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op torch thread while this module runs (six pytest-xdist
    workers share the CPU)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# --- sde-dpmsolver++ ---------------------------------------------------------

def _model_pair(rng, shape):
    """The same smooth nonlinear 'network' for both packages."""
    w = rng.standard_normal(shape[-1:]).astype(np.float32) * 0.5

    def jax_fn(x, sigma):
        return jnp.tanh(x * w) + 0.1 * jnp.sin(x) / (1.0 + sigma)

    tw = torch.from_numpy(w)

    def port_fn(x, sigma):
        return torch.tanh(x * tw) + 0.1 * torch.sin(x) / (1.0 + float(sigma))

    return jax_fn, port_fn


@pytest.mark.parametrize("order,solver_type,schedule,prediction", [
    (1, "midpoint", "karras", "epsilon"),
    (2, "midpoint", "karras", "epsilon"),
    (2, "heun", "karras", "v_prediction"),
    (2, "midpoint", "exponential", "v_prediction"),
    (2, "heun", "exponential", "epsilon"),
])
def test_sde_dpmsolver_matches_jax(rng, order, solver_type, schedule, prediction):
    steps, shape = 10, (2, 8, 8, 3)
    kw = dict(algorithm_type="sde-dpmsolver++", solver_order=order, solver_type=solver_type,
              sigma_schedule=schedule, prediction_type=prediction)
    cfg, jcfg = dpm.EDMSchedulerConfig(**kw), jdpm.EDMSchedulerConfig(**kw)
    jax_fn, port_fn = _model_pair(rng, shape)
    x0 = (rng.standard_normal(shape) * dpm.compute_sigmas(cfg, steps)[0]).astype(np.float32)
    noise = rng.standard_normal((steps,) + shape).astype(np.float32)
    want = np.asarray(jdpm.sample_dpm(jax_fn, x0, jcfg, steps, sde_noise=noise))
    got = dpm.sample_dpm(port_fn, torch.from_numpy(x0), cfg, steps,
                         sde_noise=torch.from_numpy(noise)).numpy()
    assert np.isfinite(got).all()
    assert np.max(np.abs(got - want)) / np.max(np.abs(want)) < SDE_TOL
    # the noise enters: another draw gives another sample
    other = dpm.sample_dpm(port_fn, torch.from_numpy(x0), cfg, steps,
                           sde_noise=torch.from_numpy(noise[::-1].copy())).numpy()
    assert np.max(np.abs(other - got)) > 1e-3


def test_sde_dpmsolver_raises_jax_errors():
    x = torch.zeros(1, 4, 4, 1)
    with pytest.raises(ValueError, match="needs sde_noise"):
        dpm.sample_dpm(lambda s, sig: s, x, dpm.EDMSchedulerConfig(
            algorithm_type="sde-dpmsolver++"), 4)
    with pytest.raises(ValueError, match="solver_order <= 2"):
        dpm.sample_dpm(lambda s, sig: s, x, dpm.EDMSchedulerConfig(
            algorithm_type="sde-dpmsolver++", solver_order=3), 4,
            sde_noise=torch.zeros(4, 1, 4, 4, 1))
    for jcfg in (jdpm.EDMSchedulerConfig(algorithm_type="sde-dpmsolver++"),
                 jdpm.EDMSchedulerConfig(algorithm_type="sde-dpmsolver++", solver_order=3)):
        with pytest.raises(ValueError):  # JAX's own two errors, for the record
            jdpm.sample_dpm(lambda s, sig: s, np.zeros((1, 4, 4, 1), np.float32), jcfg, 4,
                            sde_noise=None if jcfg.solver_order == 2 else np.zeros(
                                (4, 1, 4, 4, 1), np.float32))


@pytest.mark.parametrize("order", [1, 2, 3])
def test_ode_path_ignores_sde_noise_and_matches_jax(rng, order):
    """dpmsolver++ (the ODE) takes no noise: passing some changes nothing,
    and it still matches JAX's scan."""
    steps, shape = 8, (1, 6, 6, 2)
    cfg = dpm.EDMSchedulerConfig(solver_order=order)
    jax_fn, port_fn = _model_pair(rng, shape)
    x0 = (rng.standard_normal(shape) * 80.0).astype(np.float32)
    noise = torch.from_numpy(rng.standard_normal((steps,) + shape).astype(np.float32))
    plain = dpm.sample_dpm(port_fn, torch.from_numpy(x0), cfg, steps)
    with_noise = dpm.sample_dpm(port_fn, torch.from_numpy(x0), cfg, steps, sde_noise=noise)
    assert torch.equal(plain, with_noise)
    want = np.asarray(jdpm.sample_dpm(jax_fn, x0, jdpm.EDMSchedulerConfig(solver_order=order),
                                      steps))
    assert np.max(np.abs(plain.numpy() - want)) / np.max(np.abs(want)) < SDE_TOL


# --- hydrology ---------------------------------------------------------------

def _terrain(seed, h=48, w=40):
    """Seeded terrain with pits, flats and a valley: smooth waves, noise,
    a flat plateau and integer-rounded cells (ties)."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w].astype(np.float64)
    elev = (30 * np.sin(y / 7.0 + seed) + 20 * np.cos(x / 5.0) + 0.8 * (x - w / 2) ** 2 / w
            + rng.standard_normal((h, w)) * 4)
    elev[5:12, 8:16] = elev[5:12, 8:16].mean()  # a flat
    elev[30:, :10] = np.round(elev[30:, :10])   # ties
    return elev.astype(np.float32)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_d8_flow_and_accumulation_bit_equal(seed):
    elev = _terrain(seed)
    d = post.d8_flow(elev)
    np.testing.assert_array_equal(d, jax_post.d8_flow(elev))
    assert d.dtype == np.int8 and (d == -1).any() and (d >= 0).any()
    acc = post.flow_accumulation(d)
    np.testing.assert_array_equal(acc, jax_post.flow_accumulation(d))
    assert acc.dtype == np.int64 and acc.max() > 1


@pytest.mark.parametrize("max_raise,epsilon", [(np.inf, 0.0), (2.5, 0.0), (np.inf, 1e-3)])
def test_priority_flood_fill_bit_equal(max_raise, epsilon):
    elev = _terrain(3)
    got = post.priority_flood_fill(elev, max_raise=max_raise, epsilon=epsilon)
    want = jax_post.priority_flood_fill(elev, max_raise=max_raise, epsilon=epsilon)
    np.testing.assert_array_equal(got, want)
    assert got.dtype == elev.dtype and (got >= elev).all() and (got > elev).any()


@pytest.mark.parametrize("threshold", [5, 100000])
def test_river_bump_smooth_bit_equal(threshold):
    pytest.importorskip("scipy")
    elev = _terrain(4)
    acc = post.flow_accumulation(post.d8_flow(post.priority_flood_fill(elev)))
    got = post.river_bump_smooth(elev, acc, threshold=threshold, sigma=1.5)
    np.testing.assert_array_equal(got, jax_post.river_bump_smooth(elev, acc,
                                                                  threshold=threshold,
                                                                  sigma=1.5))
    assert (got is elev) == (threshold == 100000)  # no river: unchanged


# --- the native library ------------------------------------------------------

@pytest.fixture(scope="module")
def built():
    """The port's library, built by its build command, loaded by a reload
    of the package (as a process importing it after the build would)."""
    proc = subprocess.run([sys.executable, "-m", "terrain_diffusion_tpu_torch.native.build"],
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    path = proc.stdout.strip()
    assert path == native._SO_PATH and os.path.exists(path)
    assert os.path.basename(os.path.dirname(path)) == "_build"
    mod = importlib.reload(native)
    assert mod.get_native() is not None
    return mod


# (seed, frequency, octaves, lacunarity, gain): the synthetic map's channels
# and the Minecraft server's two detail noises, then other seeds and widths
PERLIN_CASES = [(1, 0.05, 4, 2.0, 0.5), (1, 0.05, 2, 2.0, 0.5), (99999, 1 / 24.0, 3, 2.0, 0.5),
                (88888, 1 / 6.0, 2, 2.0, 0.6), (2 ** 40 + 7, 0.003, 6, 2.1, 0.5),
                (-5, 0.05, 1, 2.0, 0.5)]


@pytest.mark.parametrize("case", PERLIN_CASES)
def test_native_perlin_bit_equal_jax_numpy(built, case):
    seed, freq, octaves, lac, gain = case
    ys, xs = np.mgrid[-128:128, -100:156].astype(np.float32)
    got = perlin.perlin_fbm(seed, freq, octaves, lac, gain, xs, ys)
    want = jax_perlin.perlin_fbm_np(int(seed) & 0x7FFFFFFF, freq, octaves, lac, gain, xs, ys)
    assert got.shape == xs.shape and got.dtype == np.float32 and got.std() > 0
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        perlin.perlin_fbm_np(int(seed) & 0x7FFFFFFF, freq, octaves, lac, gain, xs, ys), want)


def _octave_weights_agree(octaves, gain):
    """Whether every octave weight of ``perlin.cpp``'s float32 loop equals
    the numpy path's (float64, rounded to float32 where it is used): the
    condition for the two Perlin paths to be bit-equal."""
    f32 = np.float32
    g, amp, total = f32(abs(gain)), f32(abs(gain)), f32(1.0)
    for _ in range(1, octaves):
        total = f32(total + amp)
        amp = f32(amp * g)
    w32, w64 = f32(1.0) / total, perlin.fractal_bounding(octaves, gain)
    for _ in range(octaves):
        if f32(w64) != w32:
            return False
        w32, w64 = f32(w32 * f32(gain)), w64 * gain
    return True


def _configured_noises():
    """(name, octaves, gain) of every Perlin config the port evaluates."""
    from terrain_diffusion_tpu_torch.pipeline import synthetic_map
    from terrain_diffusion_tpu_torch.serving import minecraft_api

    cfgs = [(f"synthetic_map._MAP_CONFIGS[{i}]", c[1], c[3])
            for i, c in enumerate(synthetic_map._MAP_CONFIGS)]
    cfgs += [(f"minecraft_api.{k}", v[2], v[4]) for k, v in vars(minecraft_api).items()
             if re.fullmatch(r"_[A-Z]+_NOISE(_[A-Z]+)?", k)]
    return cfgs


def test_every_configured_perlin_noise_is_bit_equal_across_paths(built):
    """A new noise config whose octave weights round differently in
    float32 and float64 would make ``perlin_fbm`` depend on whether the
    library is built: every config must pass ``_octave_weights_agree``,
    and the two modules that call ``perlin_fbm`` are the ones enumerated."""
    pkg = os.path.dirname(os.path.dirname(perlin.__file__))
    callers = set()
    for root, _, files in os.walk(pkg):
        for f in files:
            path = os.path.join(root, f)
            if f.endswith(".py") and "perlin_fbm(" in open(path).read():
                callers.add(os.path.relpath(path, pkg))
    assert callers == {os.path.join("ops", "perlin.py"),
                       os.path.join("pipeline", "synthetic_map.py"),
                       os.path.join("serving", "minecraft_api.py")}
    cfgs = _configured_noises()
    assert len(cfgs) == 12
    ys, xs = np.mgrid[-32:32, -40:24].astype(np.float32)
    for name, octaves, gain in cfgs:
        assert _octave_weights_agree(octaves, gain), name
        np.testing.assert_array_equal(perlin.perlin_fbm(7, 0.05, octaves, 2.0, gain, xs, ys),
                                      perlin.perlin_fbm_np(7, 0.05, octaves, 2.0, gain, xs, ys),
                                      err_msg=name)


def test_native_perlin_at_an_inexact_gain_follows_jax(built):
    """Where an octave's amplitude gain ** k is not the same number in
    float32 (the C++ loop) and float64 (the numpy loop), as at gain 0.45
    over 6 octaves, the two paths differ by an ulp of that octave's
    weight, in JAX as in the port: each port path equals JAX's path of the
    same kind bit for bit."""
    from terrain_diffusion_tpu import native as jax_native

    if jax_native.lib is None:
        jax_native.build()
        jax_native = importlib.reload(jax_native)
    nat = built.get_native()
    ys, xs = np.mgrid[-64:64, 0:128].astype(np.float32)
    args = (3, 0.003, 6, 2.1, 0.45)
    got = nat.perlin_fbm_coords(*args, xs.ravel(), ys.ravel())
    np.testing.assert_array_equal(got, jax_native.lib.perlin_fbm_coords(*args, xs.ravel(),
                                                                        ys.ravel()))
    np.testing.assert_array_equal(perlin.perlin_fbm_np(*args, xs, ys),
                                  jax_perlin.perlin_fbm_np(*args, xs, ys))
    assert 0 < np.abs(got.reshape(xs.shape) - perlin.perlin_fbm_np(*args, xs, ys)).max() < 1e-7
    assert not _octave_weights_agree(6, 0.45)


def test_native_normals_bit_equal_jax_numpy(built, tmp_path):
    for seed in (0, 123, 2 ** 64 - 1):
        got = np.empty(1_000_003, np.float32)
        rng_portable.fill_standard_normal(seed, got)
        want = np.empty_like(got)
        jax_rng._fill_standard_normal_numpy(seed & 0xFFFFFFFFFFFFFFFF, want)
        np.testing.assert_array_equal(got, want)
    code = ("import os; os.environ['TDTPU_DISABLE_NATIVE']='1'\n"
            "from terrain_diffusion_tpu.ops import noise_field\n"
            "import numpy as np, sys\n"
            "np.save(sys.argv[1], noise_field.gaussian_noise_patch(1234, -3, 5, 40, 24, "
            "channels=2, tile_h=16, tile_w=16))\n")
    out = str(tmp_path / "jax_patch.npy")  # JAX's numpy path, in a process of its own
    subprocess.run([sys.executable, "-c", code, out], check=True, timeout=300,
                   env=dict(os.environ, JAX_PLATFORMS="cpu"))
    np.testing.assert_array_equal(
        noise_field.gaussian_noise_patch(1234, -3, 5, 40, 24, channels=2, tile_h=16,
                                         tile_w=16), np.load(out))


def test_import_never_compiles(built, monkeypatch):
    def boom(*a, **k):
        raise AssertionError("importing the native package ran a subprocess")

    monkeypatch.setattr(subprocess, "run", boom)
    assert importlib.reload(native).lib is not None


def test_disabled_or_stale_library_loads_as_none(built, monkeypatch, tmp_path):
    monkeypatch.setenv("TDTPU_DISABLE_NATIVE", "1")
    try:
        assert importlib.reload(native).get_native() is None
        # the numpy paths take over, with the same values
        out = np.empty(1000, np.float32)
        rng_portable.fill_standard_normal(9, out)
        ref = np.empty_like(out)
        jax_rng._fill_standard_normal_numpy(9, ref)
        np.testing.assert_array_equal(out, ref)
    finally:
        monkeypatch.delenv("TDTPU_DISABLE_NATIVE")
        importlib.reload(native)
    newer = tmp_path / "newer.cpp"
    newer.write_text("// newer than the library\n")
    os.utime(newer, (os.path.getmtime(native._SO_PATH) + 10,) * 2)
    monkeypatch.setattr(native, "_SRCS", [*native._SRCS, str(newer)])
    with pytest.raises(ImportError, match="older than its sources"):
        native._load()


def test_failed_build_is_cached(built, monkeypatch, tmp_path):
    """A failed build writes its marker; an unforced build then raises
    without running the compiler again, until forced."""
    calls = []

    def failing(cmd, **kw):
        calls.append(cmd)
        raise subprocess.CalledProcessError(1, cmd, stderr="synthetic failure")

    monkeypatch.setattr(native, "_SO_PATH", str(tmp_path / "lib.so"))
    monkeypatch.setattr(native, "_FAIL_MARKER", str(tmp_path / "failed"))
    monkeypatch.setattr(native, "_BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(subprocess, "run", failing)
    with pytest.raises(RuntimeError, match="synthetic failure"):
        native.build()
    assert os.path.exists(native._FAIL_MARKER) and len(calls) == 1
    assert calls[0][:5] == ["g++", "-O3", "-shared", "-fPIC", "-std=c++17"]
    with pytest.raises(RuntimeError, match="previously failed"):
        native.build()
    assert len(calls) == 1
    monkeypatch.undo()
    assert native.build() == native._SO_PATH
