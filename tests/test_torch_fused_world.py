"""The port's fused stage and compose path against its staged path and
against the JAX package's world, on the CPU.

Both packages get the same lively tiny models (tests/helpers.py), decoder
tiles 64/48 and buckets [1, 2, 4].  A default world (direct caching, no
mesh) keeps every stage's windows in its device tile atlas, evaluates each
stage chunk in one fused call and composes each query, or each geometry
group of ``get_many``, in one call; the JAX world takes its own fused path.
Bars:
- fused against the port's staged path (``f_fused = None`` on every stage
  tensor, ``_compose_fused`` returning None, as JAX's own test does): wire
  bytes equal with ``pack_wire=True``, float outputs within 1e-5 relative;
- against the JAX world: relative RMSE < 1e-3 per output (BASELINE.md);
- stage call counts of JAX's four ``get_many`` queries equal the JAX
  world's.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from terrain_diffusion_tpu.pipeline.world import WorldPipeline as JaxWorldPipeline

from terrain_diffusion_tpu_torch.nn.edm_unet import EDMUnet2D, EDMUnetConfig
from terrain_diffusion_tpu_torch.nn.torch_compat import params_from_jax
from terrain_diffusion_tpu_torch.parallel import Mesh
from terrain_diffusion_tpu_torch.pipeline.world import WorldPipeline

from helpers import tiny_models

KW = dict(seed=1234, latents_batch_size=[1, 2, 4], decoder_tile_size=64,
          decoder_tile_stride=48)
QUERIES = [(0, 0, 24, 24), (60, 0, 84, 24), (0, 60, 24, 84), (60, 60, 84, 84)]  # JAX's
STAGES = ("coarse", "latent_init", "latent_step", "latent_t1", "decoder", "compose")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op torch thread while this module runs: six pytest-xdist
    workers share the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _lively(tree):
    """Params with nonzero gains (init leaves them 0: constant networks)."""
    if not isinstance(tree, dict):
        return tree
    return {k: (jnp.asarray(0.3) if k == "emb_gain" else
                jnp.asarray(1.0) if k == "out_gain" else _lively(v))
            for k, v in tree.items()}


@pytest.fixture(scope="module")
def models():
    """(JAX (model, params) pairs, the port's modules with their weights)."""
    jax_models = [(m, _lively(p)) for m, p in tiny_models(decoder_tile=64)]
    port = []
    for m, p in jax_models:
        pm = EDMUnet2D(EDMUnetConfig.from_dict(m.config.to_dict()), device="cpu",
                       generator=torch.Generator().manual_seed(0))
        pm.load_state_dict(params_from_jax(pm, p))
        port.append(pm.eval())
    return jax_models, port


def _port(models, **kw):
    return WorldPipeline(device="cpu", **{**KW, **kw}).set_models(*models[1]).bind()


def _jax(models, **kw):
    ref = JaxWorldPipeline(block_impl="xla", **{**KW, **kw}).set_models(*models[0])
    ref.bind()
    return ref


def _stage_tensors(world):
    """Every stage tensor: coarse, each latent phase, residual."""
    out, t = [world.residual, world.coarse], world.latents
    while t is not world.coarse:
        out.append(t)
        t = t.args[0]
    return out


def _staged(world):
    """The same world on the staged path: no fused stage call, no fused
    compose."""
    for t in _stage_tensors(world):
        t.f_fused = None
    world._compose_fused = lambda *a, **k: None
    return world


def _calls(world):
    return {k: world.stage_timings.get(k, [0])[0] for k in STAGES}


def _rrmse(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.sqrt(np.mean((got - want) ** 2)) / np.sqrt(np.mean(want ** 2)))


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


def test_default_world_takes_the_fused_path(models):
    world = _port(models)
    tensors = _stage_tensors(world)
    assert len(tensors) == 4
    for t in tensors:
        assert t.f_fused is not None and t.defer_host
    assert [t.device_cache.capacity for t in tensors] == [96, 256, 256, 256]
    a = world.get(*QUERIES[0])
    assert world.stage_timings["compose"][0] == 1 and "compose_elev" not in world.stage_timings
    assert len(world.tile_store._data) == 0  # the windows stay in the atlases
    b = world.get(*QUERIES[0])
    assert a["elev"].tobytes() == b["elev"].tobytes()
    assert a["climate"].tobytes() == b["climate"].tobytes()
    d = world.get(8, 8, 24, 24, with_climate=False)
    assert d["climate"] is None and d["elev"].shape == (16, 16)
    world.empty_cache()
    assert all(len(t.device_cache) == 0 for t in tensors)
    again = world.get(*QUERIES[0])
    assert again["elev"].tobytes() == a["elev"].tobytes()


@pytest.mark.parametrize("noise_mode", ["threefry", "portable"])
def test_fused_equals_staged(models, noise_mode):
    """Cold get, warm get and get_many: the fused world's wire bytes equal
    the staged twin's, and its floats agree within 1e-5 relative."""
    fused, staged = _port(models, noise_mode=noise_mode), _staged(_port(models, noise_mode=noise_mode))
    for q in (QUERIES[0], QUERIES[0], (-30, 7, -6, 31)):
        a, b = fused.get(*q, pack_wire=True), staged.get(*q, pack_wire=True)
        assert a["elev"].dtype == np.int16 and a["climate"].dtype == np.float16
        assert a["elev"].tobytes() == b["elev"].tobytes(), q
        assert a["climate"].tobytes() == b["climate"].tobytes(), q
    got, want = fused.get_many(QUERIES, pack_wire=True), staged.get_many(QUERIES, pack_wire=True)
    for g, w in zip(got, want):
        assert g["elev"].tobytes() == w["elev"].tobytes()
        assert g["climate"].tobytes() == w["climate"].tobytes()
    q = (100, 100, 124, 124)
    a, b = fused.get(*q), staged.get(*q)
    for key in ("elev", "climate"):
        assert _rel(a[key], b[key]) < 1e-5, key
    assert "compose_elev" not in fused.stage_timings
    assert staged.stage_timings["compose_elev"][0] > 0
    assert fused.stage_timings["compose"][0] == 5 and _calls(staged)["compose"] == 5


VARIANTS = [{}, {"T": 1}, {"onestep_latent": True}]


@pytest.mark.parametrize("noise_mode", ["threefry", "portable"])
@pytest.mark.parametrize("variant", VARIANTS, ids=["T2", "T1", "onestep"])
def test_world_matches_jax(models, variant, noise_mode):
    """get and get_many against the JAX world's (its own fused path)."""
    kw = dict(variant, noise_mode=noise_mode)
    port, ref = _port(models, **kw), _jax(models, **kw)
    g, w = port.get(*QUERIES[0]), ref.get(*QUERIES[0])
    for key in ("elev", "climate"):
        assert _rrmse(g[key], w[key]) < 1e-3, key
    for g, w in zip(port.get_many(QUERIES[1:]), ref.get_many(QUERIES[1:])):
        for key in ("elev", "climate"):
            assert _rrmse(g[key], w[key]) < 1e-3, key
    if variant.get("T") == 1:
        assert port.stage_timings["latent_t1"][0] > 0
        assert "latent_init" not in port.stage_timings


@pytest.mark.parametrize("variant", VARIANTS[:2], ids=["T2", "T1"])
def test_get_many_stage_calls_equal_jax(models, variant):
    """JAX's four get_many queries (tests/test_pipeline.py): the same
    number of calls of every stage and of the compose as the JAX world."""
    port, ref = _port(models, **variant), _jax(models, **variant)
    port.get_many(QUERIES)
    ref.get_many(QUERIES)
    assert _calls(port) == _calls(ref)
    assert _calls(port)["compose"] == 1


def test_indirect_world_fills_the_atlas_without_fused_calls(models, tmp_path):
    """indirect caching: the HDF5 store sees every window (no deferred
    host copies, no fused stage call), the atlases fill all the same, and
    the outputs equal the direct world's."""
    pytest.importorskip("h5py")
    world = WorldPipeline(device="cpu", caching_strategy="indirect", **KW).set_models(
        *models[1]).bind(str(tmp_path / "world.h5"))
    tensors = _stage_tensors(world)
    assert all(t.f_fused is None and not t.defer_host for t in tensors)
    got = world.get(*QUERIES[0], pack_wire=True)
    assert all(len(t.device_cache) > 0 for t in tensors)
    assert world.stage_timings["compose"][0] == 1 and "compose_elev" not in world.stage_timings
    want = _port(models).get(*QUERIES[0], pack_wire=True)
    assert got["elev"].tobytes() == want["elev"].tobytes()
    assert got["climate"].tobytes() == want["climate"].tobytes()
    world.close()


def test_mesh_world_has_no_fused_stage_call(models):
    """With a mesh every stage forward shards its batch over the slots, so
    no stage is fused, as in JAX; the atlases stay on the world's device,
    and the outputs agree with the single-device world's within 1e-5
    relative (the slots' forwards run other batch sizes)."""
    world = WorldPipeline(device="cpu", mesh=Mesh.from_devices(["cpu", "cpu"]), **KW).set_models(
        *models[1]).bind()
    tensors = _stage_tensors(world)
    assert all(t.f_fused is None and t.defer_host for t in tensors)
    got = world.get(*QUERIES[0])
    assert all(t.device_cache._atlas.device == world.device for t in tensors)
    assert world.stage_timings["compose"][0] == 1 and "compose_elev" not in world.stage_timings
    want = _port(models).get(*QUERIES[0])
    for key in ("elev", "climate"):
        assert _rel(got[key], want[key]) < 1e-5, key
