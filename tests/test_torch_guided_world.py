"""The guided world (``WorldPipeline(latent_sampler="dpm")``): the undistilled
base under AutoGuidance in the latent stage, on tiny CPU worlds.

The main base model and its guide are tiny U-Nets of different widths; the
coarse and decoder models are the T=2 world's tiny ones (decoder tiles 64 /
48).  Bars:
- the world's tiles (``get``: elevation, climate, wire) against the plain
  reference of the benchmark, ``port_bench/reference/guided_world.py``
  (loaded by path: one copy serves these tests and the benchmark), float32:
  max|diff| / max|ref| < 1e-4, the per-U-Net bar;
- one window of the stage against ``evaluation/samplers.py::_dpm_tile`` with
  the same noise, conditioning and guide (that sampler is held to JAX by
  ``tests/test_torch_evaluation.py``), the same bar;
- bit for bit: ``get`` against ``get_many`` in any order and batch
  composition, and a world saved and loaded again (or served by the API);
- a one-process mesh of two CPU slots against no mesh: the per-U-Net bar.
  Not bit for bit: on the CPU a forward rounds by its batch size (the tiny
  base U-Net at batch 4 against two batches of 2: 1.5e-6), so a mesh world
  of the T=2 kind differs from its single twin too (by 1e-3 m here;
  ``tests/test_torch_parallel.py`` holds it to a relative RMSE of 1e-3);
- a bf16 world against the float32 reference: relative RMSE at most 2e-2,
  the bar of ``tests/test_torch_bf16.py``, on the climate and on the
  elevation in the signed square root that the stages compose it in (as the
  benchmark's ``elev_sqrt``).  In metres, squared, the guided world's
  bf16 elevation reads 0.030 at 4 steps (0.047 at 15, where the tiles lie
  near sea level: 163 m RMS), the T=2 world's 0.006: the 1.5 m - 0.5 g
  combination and the multistep solver carry bf16's rounding further than
  two consistency steps do (fp16 reads 0.004).
On a card (marked ``cuda``): CUDA-graph replays of both published-width base
U-Nets equal eager forwards bit for bit at two buckets in bf16, and the
fused guided world equals its staged twin on the wire.

This file imports no JAX, so the card's tests run without the repository
conftest:
    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_guided_world.py -m cuda
"""
import gc
import importlib
import importlib.util
import json
import os
import shutil
import sys

import numpy as np
import pytest
import torch

from terrain_diffusion_tpu_torch.common import spans
from terrain_diffusion_tpu_torch.evaluation.samplers import _dpm_tile
from terrain_diffusion_tpu_torch.nn.edm_unet import EDMUnet2D, EDMUnetConfig
from terrain_diffusion_tpu_torch.ops.noise_field import threefry_noise_batch
from terrain_diffusion_tpu_torch.parallel import Mesh
from terrain_diffusion_tpu_torch.pipeline.world import SCHED, SD, WorldPipeline
from terrain_diffusion_tpu_torch.runtime.cuda_graphs import ForwardGraphs
from terrain_diffusion_tpu_torch.runtime.infinite_tensor import new_counts
from terrain_diffusion_tpu_torch.scheduler.dpmsolver import compute_sigmas

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEPS = 4
KW = dict(seed=2 ** 33 + 77, latents_batch_size=[1, 2, 4], decoder_tile_size=64,
          decoder_tile_stride=48, latent_sampler="dpm", latent_steps=STEPS,
          guidance_scale=1.5)
BOXES = [(0, 0, 24, 24), (-40, 17, -8, 49), (100, -90, 124, -66), (-200, -200, -176, -176)]
COMMON = dict(layers_per_block=1, concat_balance=0.5, fourier_scale="pos", noise_emb_dims=8,
              logvar_channels=8)
CONFIGS = {
    "coarse": dict(image_size=16, in_channels=11, out_channels=6, model_channels=8,
                   model_channel_mults=[1], attn_resolutions=[], midblock_attention=False,
                   conditional_inputs=[["float", 8, 0.2]] * 5, **COMMON),
    "base": dict(image_size=64, in_channels=5, out_channels=5, model_channels=8,
                 model_channel_mults=[1, 2], attn_resolutions=[32], midblock_attention=True,
                 conditional_inputs=[["tensor", 58, 1.0]],
                 block_kwargs={"channels_per_head": 8, "attention_impl": "pallas"}, **COMMON),
    "guide": dict(image_size=64, in_channels=5, out_channels=5, model_channels=4,
                  model_channel_mults=[1, 2], attn_resolutions=[], midblock_attention=True,
                  conditional_inputs=[["tensor", 58, 1.0]],
                  block_kwargs={"channels_per_head": 4}, **COMMON),
    "decoder": dict(image_size=64, in_channels=5, out_channels=1, model_channels=8,
                    model_channel_mults=[1, 2], attn_resolutions=[], midblock_attention=False,
                    conditional_inputs=[], **COMMON),
}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op torch thread while this module runs: six pytest-xdist
    workers share the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _reference_package():
    """``port_bench/reference`` as a package of its own name, loaded by path
    (its modules import each other relatively)."""
    name = "port_bench_reference"
    if name not in sys.modules:
        pkg_dir = os.path.join(ROOT, "port_bench", "reference")
        spec = importlib.util.spec_from_file_location(
            name, os.path.join(pkg_dir, "__init__.py"), submodule_search_locations=[pkg_dir])
        pkg = importlib.util.module_from_spec(spec)
        sys.modules[name] = pkg
        spec.loader.exec_module(pkg)
    return name


def _reference(name: str):
    return importlib.import_module(f"{_reference_package()}.{name}")


def _draw_gains(model, g):
    """The block gains drawn and the output gain 1: as initialised, both are
    0 and the network is constant."""
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("emb_gain"):
                p.copy_(torch.randn((), generator=g) * 0.5)
            elif name == "out_gain":
                p.fill_(1.0)
    return model


@pytest.fixture(scope="module")
def models():
    """{name: the port's tiny model}, the gains drawn."""
    g = torch.Generator().manual_seed(31)
    return {k: _draw_gains(EDMUnet2D(EDMUnetConfig.from_dict(c), device="cpu", generator=g),
                           g).eval() for k, c in CONFIGS.items()}


def _world(models, guide=True, **kw):
    return WorldPipeline(device="cpu", **{**KW, **kw}).set_models(
        models["coarse"], models["base"], models["decoder"],
        guide=models["guide"] if guide else None).bind()


@pytest.fixture(scope="module")
def world(models):
    return _world(models)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


def _rrmse(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.sqrt(np.mean((got - want) ** 2)) / np.sqrt(np.mean(want ** 2)))


@pytest.fixture(scope="module")
def ref_world(models):
    """The plain reference over reference U-Nets with the port's weights."""
    unet = _reference("unet")
    ref_models = {}
    for k, m in models.items():
        r = unet.UNet(CONFIGS[k], device="cpu")
        r.load_state_dict({n: t for n, t in m.state_dict().items()
                           if n != "noise_fourier.freqs"})
        ref_models[k] = r.eval()
    cfg = WorldPipeline(device="cpu", **KW).get_config()
    return _reference("guided_world").GuidedRefWorld(
        ref_models["coarse"], ref_models["base"], ref_models["guide"], ref_models["decoder"],
        KW["seed"], cfg, "cpu")


# --- the tiles against the plain reference ------------------------------------

@pytest.mark.parametrize("box", BOXES)
def test_tiles_match_the_plain_reference(world, ref_world, box):
    got = world.get(*box, with_climate=True)
    wire = world.get(*box, with_climate=True, pack_wire=True)
    with torch.no_grad():
        want = ref_world.tile(*box)
    assert _rel(got["elev"], want["elev"]) < 1e-4
    assert _rel(got["climate"][:4], want["climate"][:4]) < 1e-4
    # the wire: whole metres and float16 climate, a rounding flips at most a few
    flips = np.mean(wire["elev"] != want["wire_elev"].numpy())
    assert flips < 0.01, flips
    flips = np.mean(wire["climate"][:4].astype(np.float32) != want["wire_climate"].numpy())
    assert flips < 0.01, flips


def test_one_window_is_the_evaluation_sampler(world, models):
    """The stage core of window (0, 1, -2) against ``_dpm_tile`` over the
    same noise (threefry at seed + 5819, times sigma_max), conditioning and
    guide."""
    ctxs = np.asarray([(0, 1, -2)], np.int64)
    with torch.no_grad():
        coarse = world.coarse.read([(0, 7), (0, 4), (-3, 1)])[None]
        got = world._dpm_latent_core(new_counts())(ctxs, coarse)
        noise = threefry_noise_batch(world.seed + 5819, [32], [-64], 64, 64, 5, 64, 64, "cpu")
        noise = noise.permute(0, 2, 3, 1) * float(compute_sigmas(SCHED, STEPS)[0])
        want = _dpm_tile(models["base"], models["guide"], 1.5, STEPS, SCHED, noise,
                         [world._build_cond(coarse)]) / SD
    wwin = got[:, 5:]
    assert _rel(got[:, :5] / wwin, want.permute(0, 3, 1, 2)) < 1e-4


# --- bit for bit ------------------------------------------------------------

def _bytes(out):
    return out["elev"].tobytes(), out["climate"].tobytes()


def test_get_and_get_many_are_bit_equal_in_any_order(models):
    ref = _world(models)
    want = [_bytes(ref.get(*b, pack_wire=True)) for b in BOXES]
    for order in ([3, 1, 0, 2], [2, 0], [1, 3]):
        w = _world(models)
        got = w.get_many([BOXES[i] for i in order], pack_wire=True)
        rest = [i for i in range(len(BOXES)) if i not in order]
        got_rest = w.get_many([BOXES[i] for i in rest], pack_wire=True)
        for i, g in list(zip(order, got)) + list(zip(rest, got_rest)):
            assert _bytes(g) == want[i], (order, i)


def test_a_mesh_of_two_cpu_slots_gives_the_same_tiles(models, world):
    meshed = _world(models, mesh=Mesh.from_devices(["cpu", "cpu"]))
    assert meshed.latents.f_fused is None and meshed.latents.batch_buckets == (2, 4, 8)
    calls, hook = _calls(meshed.guide_model)
    try:
        got = [meshed.get(*box) for box in BOXES[:2]]
    finally:
        hook.remove()
    assert calls and set(calls) <= {1, 2, 4}  # each slot's half of a bucket
    for box, g in zip(BOXES[:2], got):
        want = world.get(*box)
        assert _rel(g["elev"], want["elev"]) < 1e-4
        assert _rel(g["climate"], want["climate"]) < 1e-4


def test_save_and_load_round_trip_a_guided_world(models, world, tmp_path):
    pytest.importorskip("safetensors")
    world.save_pretrained(str(tmp_path))
    assert os.path.isdir(tmp_path / "guide_model")
    with open(tmp_path / "config.json") as f:
        config = json.load(f)
    assert (config["latent_sampler"], config["latent_steps"], config["guidance_scale"]) == (
        "dpm", STEPS, 1.5)
    loaded = WorldPipeline.from_pretrained(str(tmp_path), device="cpu", seed=KW["seed"],
                                           latents_batch_size=[1, 2, 4]).bind()
    assert loaded.guide_model is not None and loaded.latent_sampler == "dpm"
    assert _bytes(loaded.get(*BOXES[1], pack_wire=True)) == _bytes(
        world.get(*BOXES[1], pack_wire=True))
    again = WorldPipeline.from_local_models(
        *(str(tmp_path / f) for f in ("coarse_model", "base_model", "decoder_model")),
        guide_model_path=str(tmp_path / "guide_model"), device="cpu", seed=KW["seed"],
        latents_batch_size=[1, 2, 4],
        **{k: v for k, v in config.items() if k != "_class_name"}).bind()
    assert _bytes(again.get(*BOXES[1], pack_wire=True)) == _bytes(
        world.get(*BOXES[1], pack_wire=True))


def test_a_guided_world_without_its_guide_raises(models, world, tmp_path):
    """Only ``guidance_scale`` 1 serves the base alone: a guided world given
    no guide, or a world directory without ``guide_model/``, raises rather
    than serve the unguided base."""
    with pytest.raises(ValueError, match="guide"):
        _world(models, guide=False)
    pytest.importorskip("safetensors")
    world.save_pretrained(str(tmp_path))
    shutil.rmtree(tmp_path / "guide_model")
    with pytest.raises(ValueError, match="guide_model"):
        WorldPipeline.from_pretrained(str(tmp_path), device="cpu")
    with pytest.raises(ValueError, match="guide"):
        WorldPipeline.from_local_models(
            *(str(tmp_path / f) for f in ("coarse_model", "base_model", "decoder_model")),
            device="cpu", latent_sampler="dpm")
    unguided = WorldPipeline.from_pretrained(str(tmp_path), device="cpu", guidance_scale=1.0)
    assert unguided.guide_model is None


def test_a_consistency_world_writes_no_sampler_keys(models, tmp_path):
    config = WorldPipeline(device="cpu").get_config()
    assert not {"latent_sampler", "latent_steps", "guidance_scale"} & set(config)
    pytest.importorskip("safetensors")
    WorldPipeline(device="cpu").set_models(
        models["coarse"], models["base"], models["decoder"]).save_pretrained(str(tmp_path))
    assert not os.path.exists(tmp_path / "guide_model")


def test_the_api_server_serves_a_saved_guided_world(world, tmp_path, monkeypatch):
    pytest.importorskip("safetensors")
    from terrain_diffusion_tpu_torch.serving import api

    world.save_pretrained(str(tmp_path))
    monkeypatch.setattr(api.app, "run", lambda **kw: None)  # configure, load, bind; no socket
    try:
        api.main([str(tmp_path), "--device", "cpu", "--seed", str(KW["seed"]),
                  "--batch-size", "1,2,4", "--log-mode", "info"])
        served = api._get_pipeline()
        assert served.latent_sampler == "dpm" and served.guide_model is not None
        assert _bytes(served.get(*BOXES[0], pack_wire=True)) == _bytes(
            world.get(*BOXES[0], pack_wire=True))
    finally:
        api.configure()


# --- forwards, counters and spans ----------------------------------------------

def _calls(model):
    calls = []
    return calls, model.register_forward_pre_hook(lambda m, a: calls.append(a[0].shape[0]))


def test_guided_forwards_count_twice_the_steps_a_batch(models):
    w = _world(models)
    calls, hook = _calls(w.guide_model)
    try:
        w.get_many(BOXES[:2])
    finally:
        hook.remove()
    batches = w.stage_timings["latent_dpm"][0]
    c = w.counters()["latent_dpm"]
    assert batches > 0 and c["windows"] > 0
    assert c["forwards"] == 2 * STEPS * batches
    assert len(calls) == STEPS * batches
    assert set(w.counters()) == {"coarse", "latent_dpm", "decoder"}
    assert "latent_init" not in w.stage_timings and "latent_step" not in w.stage_timings


@pytest.mark.parametrize("guide", [True, False], ids=["scale1", "no_guide"])
def test_scale_one_or_no_guide_never_calls_the_guide(models, guide):
    w = _world(models, guide=guide, guidance_scale=1.0)
    calls, hook = _calls(models["guide"])
    try:
        out = w.get(*BOXES[0], pack_wire=True)
    finally:
        hook.remove()
    assert calls == []
    c = w.counters()["latent_dpm"]
    assert c["forwards"] == STEPS * w.stage_timings["latent_dpm"][0]
    # the base alone: the same as a world with no guide at all
    assert _bytes(out) == _bytes(_world(models, guide=False, guidance_scale=1.0).get(
        *BOXES[0], pack_wire=True))


def test_profile_labels_the_guided_stage_and_the_guide(models, tmp_path):
    w = _world(models)
    w.get_many([(200000, 200000, 200024, 200024)])  # warm, far from the profiled tiles
    with w.profile(str(tmp_path / "trace")):
        w.get_many(BOXES[:2])
    with open(tmp_path / "trace" / "trace.json", encoding="utf-8") as f:
        names = {e["name"] for e in json.load(f)["traceEvents"] if e.get("ph") == "X"
                 and e.get("cat") == "user_annotation" and e["name"].startswith(spans.PREFIX)}
    for want in ("td.get_many", "td.plan", "td.prefetch", "td.latent_dpm", "td.coarse",
                 "td.decoder"):
        assert want in names, (want, sorted(names))
    fwd = {n.split(".")[2] for n in names if n.startswith("td.fwd.")}
    assert fwd == {"coarse", "base", "guide", "decoder"}, sorted(names)


def _signed_sqrt(x):
    return np.sign(x) * np.sqrt(np.abs(x))


def test_a_bf16_world_stays_within_the_bf16_bar(models, ref_world):
    """Measured on the CPU with these models: relative RMSE 0.0150 for the
    elevation's signed square root, 0.0063 for the climate (the module
    docstring has the elevation in metres)."""
    w = _world(models, dtype="bf16")
    assert w.compute_dtype == torch.bfloat16
    got = w.get_many(BOXES)
    with torch.no_grad():
        want = [ref_world.tile(*b) for b in BOXES]
    g = np.concatenate([np.ravel(o["elev"]) for o in got])
    r = np.concatenate([np.ravel(t["elev"].numpy()) for t in want])
    assert np.isfinite(g).all()
    assert _rrmse(_signed_sqrt(g), _signed_sqrt(r)) <= 2e-2, _rrmse(_signed_sqrt(g), _signed_sqrt(r))
    g = np.concatenate([np.ravel(o["climate"][:4]) for o in got])
    r = np.concatenate([np.ravel(t["climate"][:4].numpy()) for t in want])
    assert np.isfinite(g).all()
    assert _rrmse(g, r) <= 2e-2, _rrmse(g, r)


def test_the_guided_world_makes_graph_inputs_at_a_first_forward(models):
    """The guided world's graphs make a model's static inputs at its first
    forward, sized for its largest bucket (so the memory peak does not
    depend on which signatures recur).  On the CPU the world's forwards do
    not run through the graphs, so the cache is called directly, as
    ``_forward`` calls it on a card."""
    w = _world(models)
    cache, counts = w._graphs, new_counts()
    g = torch.Generator().manual_seed(5)
    x, nl = torch.randn((2, 64, 64, 5), generator=g), torch.randn((2,), generator=g)
    cond = [torch.randn((2, 58), generator=g)]
    with torch.no_grad():
        got = cache(w.guide_model, x, nl, cond, counts)
        want = w.guide_model(x, nl, cond)
    assert torch.equal(got, want) and counts["captures"] == counts["replays"] == 0
    (bufs,) = [b for k, b in cache._buffers.items() if k[0] == id(w.guide_model)]
    assert [tuple(b.shape) for b in bufs] == [(4, 64, 64, 5), (4,), (4, 58)]


@pytest.mark.parametrize("kw,match", [
    (dict(T=1), "T=1"), (dict(onestep_latent=True), "onestep_latent"),
    (dict(latent_steps=0), "latent_steps"), (dict(latent_sampler="ddim"), "latent_sampler")])
def test_an_invalid_combination_raises(kw, match):
    with pytest.raises(ValueError, match=match):
        WorldPipeline(device="cpu", **{**KW, **kw})


# --- on the card ----------------------------------------------------------------

BASE_CONFIGS = {"base": "configs/diffusion_base/diffusion_192-3.cfg",
                "guide": "configs/diffusion_base/diffusion_128-3.cfg"}


@pytest.fixture
def free_card():
    gc.collect()
    torch.cuda.empty_cache()
    yield
    gc.collect()
    torch.cuda.empty_cache()


@pytest.fixture(scope="module")
def card_models():
    """The base model and its guide at their published widths, and the coarse
    and decoder models of the served world, random weights (the gains
    drawn), on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from terrain_diffusion_tpu_torch import use_full_f32
    from terrain_diffusion_tpu_torch.training.registry import load_config

    use_full_f32()
    g = torch.Generator().manual_seed(41)
    rels = dict(BASE_CONFIGS, coarse="configs/diffusion_coarse/diffusion_coarse.cfg",
                decoder="configs/diffusion_decoder/diffusion_decoder_64-3.cfg")
    out = {}
    for name, rel in rels.items():
        cfg = load_config(os.path.join(ROOT, rel))["model"]
        if name in BASE_CONFIGS:  # the JAX value that routes their attention to the kernel
            cfg["block_kwargs"] = {**cfg.get("block_kwargs", {}), "attention_impl": "pallas"}
        out[name] = _draw_gains(EDMUnet2D(EDMUnetConfig.from_dict(cfg), device="cuda",
                                          generator=g), g).eval()
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["base", "guide"])
def test_replay_equals_eager_for_both_base_unets_on_the_card(card_models, free_card, name):
    model = card_models[name]
    cache, counts = ForwardGraphs(), new_counts()
    cache.reserve(model, 16)
    g = torch.Generator().manual_seed(42)
    outs = []
    with torch.no_grad():
        for n in (2, 16):
            for _ in range(4):  # eager, capture + replay, replay, replay
                x = torch.randn((n, 64, 64, 5), generator=g).cuda().to(torch.bfloat16)
                nl = torch.randn((n,), generator=g).cuda().to(torch.bfloat16)
                cond = [torch.randn((n, 58), generator=g).cuda().to(torch.bfloat16)]
                outs.append((model(x, nl, cond), cache(model, x, nl, cond, counts)))
    for k, (want, got) in enumerate(outs):
        assert got.dtype == want.dtype and torch.equal(got, want), k
    assert counts["captures"] == 2 and counts["replays"] == 6


def _staged(world):
    for t in (world.residual, world.latents, world.coarse):
        t.f_fused = None
    world._compose_fused = lambda *a, **k: None
    return world


@pytest.mark.cuda
def test_fused_guided_world_equals_staged_on_the_card(card_models, free_card):
    tiles = [(0, 0, 256, 256), (0, 256, 256, 512), (256, 0, 512, 256)]

    def serve(world):
        outs = [world.get(*tiles[0], pack_wire=True)]
        outs += world.get_many(tiles[1:], pack_wire=True)
        counts = world.counters()
        world.close()
        return outs, counts

    def make():
        return WorldPipeline(seed=2026, device="cuda", dtype="bf16", latent_sampler="dpm",
                             latent_steps=15, guidance_scale=1.5).set_models(
            card_models["coarse"], card_models["base"], card_models["decoder"],
            guide=card_models["guide"]).bind()

    want, staged_counts = serve(_staged(make()))
    got, fused_counts = serve(make())
    for a, b in zip(got, want):
        assert a["elev"].tobytes() == b["elev"].tobytes()
        assert a["climate"].tobytes() == b["climate"].tobytes()
    for c in (staged_counts, fused_counts):
        assert c["latent_dpm"]["replays"] > 0, c
