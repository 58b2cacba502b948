"""The port's device mesh and tile-parallel serving on the CPU
(terrain_diffusion_tpu_torch.parallel, WorldPipeline(mesh=, block_impl=)):

- mesh helpers: a one-process mesh splits a batch into one chunk a slot on
  its slot's device, replicates a leaf whose leading size the slot count
  does not divide, and makes one replica a distinct device (slots on one
  device share it); a CUDA mesh is never made on a machine without a card;
- the mesh world: the port's world on an 8-slot CPU mesh against JAX's
  world on its 8-device CPU mesh (tests/conftest.py), both with
  latents_batch_size=[1, 2], as tests/test_pipeline.py::test_mesh_tile_parallel
  runs it, and against the port's single-device world: coarse[:, 0:8, 0:8]
  within rtol 1e-4, atol 1e-5 (JAX's bar); finite latents; a get within
  relative RMSE 1e-3 of the single-device world's (the world bar);
- block_impl="xla": the world's models have their kernel switch off and
  share the given weights, also through from_pretrained (the servers'
  --kwarg); its get equals the "pallas" world's within 1e-4;
- mesh= scales every stage's buckets to multiples of the slot count.
"""
import numpy as np
import pytest
import torch

from terrain_diffusion_tpu.parallel import make_mesh as jax_make_mesh
from terrain_diffusion_tpu.pipeline.world import WorldPipeline as JaxWorldPipeline

from terrain_diffusion_tpu_torch.nn.edm_unet import EDMUnet2D, EDMUnetConfig
from terrain_diffusion_tpu_torch.nn.layers import UNetBlock, with_block_impl
from terrain_diffusion_tpu_torch.nn.torch_compat import params_from_jax
from terrain_diffusion_tpu_torch.parallel import Mesh, make_mesh, replicate, shard_batch
from terrain_diffusion_tpu_torch.parallel.mesh import local_rows, take_rows
from terrain_diffusion_tpu_torch.pipeline.world import WorldPipeline

from helpers import tiny_models

KW = dict(seed=1234, latents_batch_size=[1, 2], decoder_tile_size=64, decoder_tile_stride=48)
CPU8 = ["cpu"] * 8


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op torch thread while this module runs: six pytest-xdist
    workers share the CPU, and torch's default of a thread per core makes
    each small op wait on descheduled siblings."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rrmse(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.sqrt(np.mean((got - want) ** 2)) / np.sqrt(np.mean(want ** 2)))


@pytest.fixture(scope="module")
def models():
    """(JAX (model, params) pairs, the port's models with the same weights);
    the gains are nonzero so the networks are not constant."""
    import jax.numpy as jnp

    def lively(tree):
        if not isinstance(tree, dict):
            return tree
        return {k: (jnp.asarray(0.3) if k == "emb_gain" else
                    jnp.asarray(1.0) if k == "out_gain" else lively(v))
                for k, v in tree.items()}

    pairs = [(m, lively(p)) for m, p in tiny_models(decoder_tile=64)]
    port = []
    for m, p in pairs:
        pm = EDMUnet2D(EDMUnetConfig.from_dict(m.config.to_dict()), device="cpu",
                       generator=torch.Generator().manual_seed(0))
        pm.load_state_dict(params_from_jax(pm, p))
        port.append(pm)
    return pairs, port


@pytest.fixture(scope="module")
def worlds(models):
    _, port = models
    single = WorldPipeline(device="cpu", **KW).set_models(*port).bind()
    meshed = WorldPipeline(device="cpu", mesh=Mesh.from_devices(CPU8), **KW)
    return single, meshed.set_models(*port).bind()


# ---------------------------------------------------------------------------
# mesh helpers
# ---------------------------------------------------------------------------

def test_shard_batch_splits_and_replicates_an_indivisible_leaf():
    mesh = Mesh.from_devices(["cpu"] * 4)
    batch = {"x": torch.arange(8.0).reshape(8, 1), "odd": np.arange(6.0),
             "cond": [np.ones((8, 2))], "scalar": 3}
    shards = shard_batch(mesh, batch)
    assert len(shards) == 4
    for i, s in enumerate(shards):
        assert torch.equal(s["x"], torch.tensor([[2.0 * i], [2.0 * i + 1]]))
        assert torch.equal(s["odd"], torch.arange(6.0, dtype=torch.float64))
        assert s["cond"][0].shape == (2, 2) and s["scalar"] == 3
    assert mesh.size == 4 and mesh.distinct() == [torch.device("cpu")]
    assert local_rows(mesh, 8) == (8, 0, 8)  # one process holds every row


def test_replicate_shares_one_copy_a_device():
    model = torch.nn.Linear(2, 2)
    mesh = Mesh.from_devices(["cpu", "cpu", "cpu"])
    reps = replicate(mesh, model)
    assert len(reps) == 3 and all(r is model for r in reps)
    tensors = replicate(mesh, {"w": torch.ones(2)})
    assert all(torch.equal(t["w"], torch.ones(2)) for t in tensors)


def test_rows_and_take_rows():
    from terrain_diffusion_tpu_torch.parallel.mesh import Rows

    rows = Rows(6, 2, 4)
    tree = {"a": torch.arange(6), "b": [torch.arange(12).reshape(6, 2)], "seed": 7}
    cut = take_rows(tree, rows)
    assert cut["a"].tolist() == [2, 3] and cut["b"][0].shape == (2, 2) and cut["seed"] == 7
    assert rows.sharded and not Rows(6, 0, 6).sharded


def test_make_mesh_needs_a_card_or_asks_for_the_cpu():
    if torch.cuda.is_available():
        assert make_mesh().size == torch.cuda.device_count()
    else:
        with pytest.raises(RuntimeError, match="Mesh.from_devices"):
            make_mesh()
    assert Mesh.from_devices(CPU8).size == 8


# ---------------------------------------------------------------------------
# the mesh world
# ---------------------------------------------------------------------------

def test_mesh_buckets_are_multiples_of_the_slots(worlds):
    single, meshed = worlds
    assert single.coarse.batch_buckets == (1, 2, 4, 8, 16, 32)
    assert meshed.coarse.batch_buckets == (8, 16, 32, 64, 128, 256)
    assert meshed.latents.batch_buckets == (8, 16)
    assert meshed.residual.batch_buckets == (8, 16, 32, 64, 128)
    with pytest.raises(TypeError, match="mesh"):
        WorldPipeline(device="cpu", mesh=object())


def test_mesh_world_matches_jax_mesh_world_and_the_single_world(models, worlds):
    pairs, _ = models
    single, meshed = worlds
    mesh = jax_make_mesh()
    assert int(np.prod(mesh.devices.shape)) == 8
    ref = JaxWorldPipeline(mesh=mesh, block_impl="xla", **KW).set_models(*pairs)
    ref.bind()
    with torch.no_grad():
        got = meshed.coarse[:, 0:8, 0:8]
        want = single.coarse[:, 0:8, 0:8]
    np.testing.assert_allclose(got, np.asarray(ref.coarse[:, 0:8, 0:8]), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    with torch.no_grad():
        assert np.isfinite(meshed.latents[:, 0:8, 0:8]).all()


def test_mesh_world_get_matches_the_single_world(worlds):
    single, meshed = worlds
    a, b = meshed.get(0, 0, 24, 24), single.get(0, 0, 24, 24)
    assert _rrmse(a["elev"], b["elev"]) < 1e-3
    assert _rrmse(a["climate"], b["climate"]) < 1e-3


def test_mesh_world_runs_each_chunk_on_its_replica(models):
    """Every slot's replica runs one chunk of each forward: 8 calls of a
    batch of 1 for a padded bucket of 8."""
    _, port = models
    world = WorldPipeline(device="cpu", mesh=Mesh.from_devices(CPU8), **KW).set_models(*port)
    calls = []
    hook = world.decoder_model.register_forward_pre_hook(
        lambda m, args: calls.append(args[0].shape[0]))
    try:
        world.bind()
        with torch.no_grad():
            world.residual.read([(0, 2), (0, 48), (0, 48)])
    finally:
        hook.remove()
    assert calls and set(calls) == {1} and len(calls) % 8 == 0


# ---------------------------------------------------------------------------
# block_impl
# ---------------------------------------------------------------------------

def test_block_impl_xla_takes_the_plain_path(models, worlds, tmp_path):
    _, port = models
    single, _ = worlds
    world = WorldPipeline(device="cpu", block_impl="xla", **KW).set_models(*port).bind()
    for given, used in zip(port, (world.coarse_model, world.base_model, world.decoder_model)):
        assert used is not given and not used.block_kernels
        assert all(not b.block_kernels for b in used.modules() if isinstance(b, UNetBlock))
        assert used.out_conv.weight is given.out_conv.weight  # the same weights
        assert given.block_kernels  # the caller's model is untouched
    assert single.decoder_model is port[2]  # "pallas": the models as given
    a, b = world.get(0, 0, 24, 24), single.get(0, 0, 24, 24)
    np.testing.assert_allclose(a["elev"], b["elev"], rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(a["climate"], b["climate"], rtol=1e-4, atol=1e-4)
    assert with_block_impl(world.decoder_model, "xla") is world.decoder_model
    with pytest.raises(ValueError, match="block_impl"):
        WorldPipeline(device="cpu", block_impl="mosaic")
    # the servers' --kwarg block_impl=xla reaches the world through from_pretrained
    single.save_pretrained(str(tmp_path / "world"))
    loaded = WorldPipeline.from_pretrained(str(tmp_path / "world"), device="cpu",
                                           block_impl="xla")
    assert not loaded.decoder_model.block_kernels and loaded.block_impl == "xla"
