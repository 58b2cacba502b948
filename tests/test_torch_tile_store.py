"""The port's HDF5 tile store and indirect caching against the JAX package,
on the CPU.

Both packages load one world directory, saved by the port from the tiny
models of tests/helpers.py (seeded, nonzero gains), decoder tiles 64/48,
threefry noise, T=2.  Bars:
- the stores: the same arrays, names and parameters, bit for bit, in files
  written by either package;
- a world file written by one package and opened by the other: no stage
  window is recomputed (no stage forward runs), and the elevation is the
  writer's within 1 m (only the composition differs: Laplacian denoise and
  decode in torch or in JAX);
- reopen, reconcile, rebuild, TEMP and the context manager follow JAX's
  tests/test_pipeline.py cases, on the port alone.
"""
import json
import os
import sys

import numpy as np
import pytest
import torch

from terrain_diffusion_tpu.pipeline.world import WorldPipeline as JaxWorldPipeline
from terrain_diffusion_tpu.runtime import HDF5TileStore as JaxHDF5TileStore
from terrain_diffusion_tpu.serving import world_generator as jax_wg

from terrain_diffusion_tpu_torch.pipeline import world as world_mod
from terrain_diffusion_tpu_torch.nn.edm_unet import EDMUnet2D, EDMUnetConfig
from terrain_diffusion_tpu_torch.pipeline.world import WorldPipeline
from terrain_diffusion_tpu_torch.runtime.tile_store import HDF5TileStore, MemoryTileStore
from terrain_diffusion_tpu_torch.serving import world_generator as wg

h5py = pytest.importorskip("h5py")

KW = dict(latents_batch_size=[1, 2, 4], log_mode="info")
SEED = 4321
STAGES = ("coarse", "latent_init", "latent_step", "latent_t1", "decoder")
QUERY = (8, -16, 56, 32)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op torch thread while this module runs (six pytest-xdist
    workers share the CPU)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# tests/helpers.py::tiny_models' configs (decoder tile 64)
TINY = [
    dict(image_size=16, in_channels=11, out_channels=6, model_channels=8,
         model_channel_mults=(1,), layers_per_block=1, attn_resolutions=(),
         midblock_attention=False, concat_balance=0.5,
         conditional_inputs=tuple(("float", 8, 0.2) for _ in range(5)),
         fourier_scale="pos", noise_emb_dims=8, logvar_channels=8),
    dict(image_size=64, in_channels=5, out_channels=5, model_channels=8,
         model_channel_mults=(1, 2), layers_per_block=1, attn_resolutions=(),
         midblock_attention=False, concat_balance=0.5,
         conditional_inputs=(("tensor", 58, 1.0),), fourier_scale="pos",
         noise_emb_dims=8, logvar_channels=8),
    dict(image_size=64, in_channels=5, out_channels=1, model_channels=8,
         model_channel_mults=(1, 2), layers_per_block=1, attn_resolutions=(),
         midblock_attention=False, concat_balance=0.5, conditional_inputs=(),
         fourier_scale="pos", noise_emb_dims=8, logvar_channels=8),
]


@pytest.fixture(scope="module")
def world_dir(tmp_path_factory):
    """A world directory both packages load: the port's seeded tiny models
    with block gains 0.3 and out gain 1 (init leaves them 0: constant
    networks), saved by the port, which spares compiling JAX's init."""
    pytest.importorskip("safetensors")
    path = str(tmp_path_factory.mktemp("world"))
    g = torch.Generator().manual_seed(7)
    models = [EDMUnet2D(EDMUnetConfig(**cfg), device="cpu", generator=g) for cfg in TINY]
    with torch.no_grad():
        for m in models:
            for name, p in m.named_parameters():
                if name.endswith("emb_gain"):
                    p.fill_(0.3)
                elif name == "out_gain":
                    p.fill_(1.0)
    WorldPipeline(seed=SEED, decoder_tile_size=64, decoder_tile_stride=48,
                  device="cpu").set_models(*models).save_pretrained(path)
    return path


def _port(world_dir, **kw):
    return WorldPipeline.from_pretrained(world_dir, **{"seed": SEED, **KW, **kw}, device="cpu")


def _jax(world_dir, **kw):
    return JaxWorldPipeline.from_pretrained(world_dir, block_impl="xla",
                                            **{"seed": SEED, **KW, **kw})


def _stage_calls(pipe) -> dict:
    return {k: v[0] for k, v in pipe.stage_timings.items() if k in STAGES}


# --- the stores -------------------------------------------------------------

def _fill(store, rng):
    arrays = {("leaf", (0, i, j)): rng.standard_normal((3, 8, 8)).astype(np.float32)
              for i in (-1, 0, 2) for j in (0, 5)}
    arrays[("other", (0, 0, 0))] = rng.standard_normal((2, 4, 4)).astype(np.float32)
    for (tid, idx), a in arrays.items():
        store.put(tid, idx, a)
    store.set_params({"seed": 5, "kwargs": {"b": [1.5, 3], "a": "x"}})
    return arrays


@pytest.mark.parametrize("writer,reader", [(HDF5TileStore, JaxHDF5TileStore),
                                           (JaxHDF5TileStore, HDF5TileStore)],
                         ids=["port_writes", "jax_writes"])
def test_hdf5_store_files_cross_both_ways(tmp_path, rng, writer, reader):
    path = str(tmp_path / "tiles.h5")
    store = writer(path)
    arrays = _fill(store, rng)
    store.close()
    with h5py.File(path, "r") as f:
        assert sorted(f.keys()) == ["leaf", "other"]
        assert "leaf/0_-1_5" in f and f["leaf/0_-1_5"].dtype == np.float32
        assert json.loads(f.attrs["WORLD_PIPELINE_PARAMS"]) == {
            "kwargs": {"a": "x", "b": [1.5, 3]}, "seed": 5}
    back = reader(path)
    assert back.get_params() == {"seed": 5, "kwargs": {"b": [1.5, 3], "a": "x"}}
    for (tid, idx), a in arrays.items():
        assert back.contains(tid, idx)
        np.testing.assert_array_equal(back.get(tid, idx), a)
    assert back.get("leaf", (0, 9, 9)) is None and not back.contains("leaf", (0, 9, 9))
    back.clear("leaf")
    assert not back.contains("leaf", (0, 0, 0)) and back.contains("other", (0, 0, 0))
    back.close()


def test_hdf5_store_matches_jax_operation_by_operation(tmp_path, rng):
    port, ref = HDF5TileStore(str(tmp_path / "a.h5")), JaxHDF5TileStore(str(tmp_path / "b.h5"))
    a, b = rng.standard_normal((2, 3, 5, 5)).astype(np.float32)
    for store in (port, ref):
        assert store.get_params() is None
        store.put("t", (0, 1, 2), a)
        store.put("t", (0, 1, 2), b)  # a rewrite replaces the dataset
        store.put("u", (0, 0, 0), a)
    for k in [("t", (0, 1, 2)), ("u", (0, 0, 0)), ("t", (0, 0, 0))]:
        assert port.contains(*k) == ref.contains(*k)
        g, w = port.get(*k), ref.get(*k)
        assert (g is None) == (w is None)
        if g is not None:
            np.testing.assert_array_equal(g, w)
    port.clear()
    ref.clear()
    assert list(port.file.keys()) == list(ref.file.keys()) == []
    port.close()
    port.close()  # closing twice is harmless, as in JAX
    ref.close()


def test_memory_store_clears_one_tensor_and_closes():
    store = MemoryTileStore()
    store.put("a", (0, 0, 0), torch.ones(2, 4, 4))
    store.put("a", (0, 1, 0), torch.ones(2, 4, 4))
    store.put("b", (0, 0, 0), torch.ones(3, 4, 4))
    store.clear("a")
    assert not store.contains("a", (0, 0, 0)) and store.contains("b", (0, 0, 0))
    assert store._bytes == 3 * 16 * 4
    store.close()
    assert not store.contains("b", (0, 0, 0)) and store._bytes == 0


# --- indirect caching on the port --------------------------------------------

def test_indirect_persistence_and_reopen(world_dir, tmp_path):
    path = str(tmp_path / "world.h5")
    p = _port(world_dir, caching_strategy="indirect").bind(path)
    coarse = p.coarse[:, 0:4, 0:4]
    assert isinstance(coarse, np.ndarray) and coarse.dtype == np.float32
    elev = p.get(*QUERY)["elev"]
    assert _stage_calls(p)["decoder"] > 0
    p.close()
    assert os.path.exists(path)  # a named world file stays
    with _port(world_dir, caching_strategy="indirect").bind(path) as p2:
        np.testing.assert_array_equal(p2.coarse[:, 0:4, 0:4], coarse)
        np.testing.assert_array_equal(p2.get(*QUERY)["elev"], elev)
        assert _stage_calls(p2) == {}, "persisted windows were recomputed"
    # the same world in memory
    direct = _port(world_dir).bind()
    np.testing.assert_array_equal(direct.get(*QUERY)["elev"], elev)


def test_reconcile_adopts_stored_world_params(world_dir, tmp_path):
    f = str(tmp_path / "world.h5")
    p = _port(world_dir, caching_strategy="indirect", drop_water_pct=0.25).bind(hdf5_file=f)
    assert p.kwargs["drop_water_pct"] == 0.25
    p.tile_store.close()

    p2 = _port(world_dir, caching_strategy="indirect", drop_water_pct=0.9, seed=7,
               log_mode="verbose").bind(hdf5_file=f)
    assert p2.kwargs["drop_water_pct"] == 0.25 and p2.seed == SEED  # stored wins
    assert p2.log_mode == "verbose"  # the runtime knob is kept
    assert p2.latent_compression == p2.kwargs["latent_compression"]
    p2.tile_store.close()

    # a world file of the JAX package: the port adopts its parameters too
    g = str(tmp_path / "jax.h5")
    ref = _jax(world_dir, caching_strategy="indirect", drop_water_pct=0.4)
    ref.bind(g)
    ref.close()
    p3 = _port(world_dir, caching_strategy="indirect").bind(hdf5_file=g)
    assert p3.kwargs["drop_water_pct"] == 0.4
    assert {k: v for k, v in ref.kwargs.items() if k != "log_mode"} == p3.kwargs
    p3.close()
    # and the other way round
    p4 = _port(world_dir, caching_strategy="indirect", drop_water_pct=0.6).bind(
        str(tmp_path / "port.h5"))
    p4.close()
    ref2 = _jax(world_dir, caching_strategy="indirect")
    ref2.bind(str(tmp_path / "port.h5"))
    assert ref2.kwargs["drop_water_pct"] == 0.6
    ref2.close()


def test_rebuild_starts_the_world_file_afresh(world_dir, tmp_path):
    path = str(tmp_path / "world.h5")
    p = _port(world_dir, caching_strategy="indirect").bind(path)
    p.coarse[:, 0:2, 0:2]
    assert len(p.tile_store.file.keys()) > 0
    assert p.change_seed(99)
    assert list(p.tile_store.file.keys()) == []
    assert p.tile_store.get_params()["seed"] == 99
    new = p.coarse[:, 0:2, 0:2]
    p.close()
    with _port(world_dir, seed=99).bind() as direct:
        np.testing.assert_array_equal(direct.coarse[:, 0:2, 0:2], new)


def test_temp_world_file_is_removed_on_close(world_dir):
    with _port(world_dir, caching_strategy="indirect").bind("TEMP") as p:
        path = p._hdf5_file_path
        assert path in world_mod._TEMP_FILES and os.path.exists(path)
        p.coarse[:, 0:2, 0:2]
    assert not os.path.exists(path) and path not in world_mod._TEMP_FILES
    assert p.tile_store is None
    with pytest.raises(ValueError, match="hdf5_file is required"):
        _port(world_dir, caching_strategy="indirect").bind()


def test_indirect_without_h5py_raises_and_never_falls_back(world_dir, tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "h5py", None)
    p = _port(world_dir, caching_strategy="indirect")
    with pytest.raises(ImportError):
        p.bind(str(tmp_path / "world.h5"))
    assert p.tile_store is None


def test_16bit_world_from_the_file_equals_the_world_in_memory(world_dir, tmp_path):
    """bf16 windows go to the file as float32 and come back exactly."""
    path = str(tmp_path / "bf16.h5")
    with _port(world_dir, dtype="bf16", caching_strategy="indirect").bind(path) as p:
        from_file = p.get(*QUERY)["elev"]
        latents = p.latents[:, -2:6, 0:6]
        assert p.tile_store.file["init_residual_map/0_0_0"].dtype == np.float32
    with _port(world_dir, dtype="bf16").bind() as m:
        np.testing.assert_array_equal(m.get(*QUERY)["elev"], from_file)
        np.testing.assert_array_equal(m.latents[:, -2:6, 0:6], latents)


def test_getitem_clear_cache_profile_and_local_models(world_dir, tmp_path):
    folders = [os.path.join(world_dir, f) for f in ("coarse_model", "base_model",
                                                    "decoder_model")]
    p = WorldPipeline.from_local_models(*folders, seed=SEED, device="cpu", decoder_tile_size=64,
                                        decoder_tile_stride=48, **KW).bind()
    ref = _port(world_dir).bind()
    with p.profile(str(tmp_path / "trace")):
        a = p.residual[:, 0:16, 0:16]
    assert os.path.getsize(tmp_path / "trace" / "trace.json") > 0
    np.testing.assert_array_equal(a, ref.residual[:, 0:16, 0:16])
    assert a.shape == (2, 16, 16) and p.residual[0, 3, 4].shape == (1, 1, 1)
    with pytest.raises(IndexError):
        p.residual[:, :, 0:4]  # unbounded dims need coordinates
    p.coarse[:, 0:2, 0:2]
    p.residual.clear_cache()  # the residual and its parents, down to the coarse stage
    assert len(p.tile_store._data) == 0
    p.latents[:, 0:4, 0:4]
    p.residual[:, 0:4, 0:4]
    p.residual.clear_cache()
    p.latents.clear_cache()
    assert len(p.tile_store._data) == 0


# --- world files crossing both ways ------------------------------------------

def _generate(package, world_dir, h5):
    kw = dict(hdf5_file=h5, seed=SEED, coarse_window=1, caching_strategy="indirect",
              tile_size=512, latents_batch_size=[1, 2, 4], log_mode="info")
    if package == "jax":
        jax_wg.generate_world(world_dir, block_impl="xla", **kw)
    else:
        out = wg.generate_world(world_dir, device="cpu", **kw)
        assert out["seed"] == SEED and out["decoder_windows"] > 0


def _elev_from_file(package, world_dir, h5):
    pipe = (_jax if package == "jax" else _port)(world_dir, caching_strategy="indirect")
    pipe.bind(h5)
    elev = np.asarray(pipe.get(*QUERY, with_climate=False)["elev"], np.float64)
    calls = _stage_calls(pipe)
    pipe.close()
    return elev, calls


@pytest.mark.parametrize("writer", ["jax", "port"], ids=["jax_writes", "port_writes"])
def test_world_file_opens_in_the_other_package(world_dir, tmp_path, writer):
    h5 = str(tmp_path / "world.h5")
    _generate(writer, world_dir, h5)
    with h5py.File(h5, "r") as f:
        assert {"base_coarse_map", "init_latent_map", "step_latent_map_0",
                "init_residual_map"} <= set(f.keys())
    reader = "port" if writer == "jax" else "jax"
    got, calls = _elev_from_file(reader, world_dir, h5)
    assert calls == {}, f"the {reader} reader recomputed windows of the writer's file"
    want, calls = _elev_from_file(writer, world_dir, h5)
    assert calls == {}
    assert got.shape == want.shape == (QUERY[2] - QUERY[0], QUERY[3] - QUERY[1])
    assert np.max(np.abs(got - want)) <= 1.0
    assert np.std(got) > 0
