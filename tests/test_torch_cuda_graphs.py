"""CUDA graphs of the stage forwards (``runtime/cuda_graphs.py``).

On the CPU (tier 1):

- the graph key is built from the model and the shapes and types of every
  input, so two forwards of one bucket share a key and two buckets do not;
- a CPU world never engages graphs: ``forwards`` counts every stage model
  call (the forward hooks' count) and ``captures`` and ``replays`` stay 0;
  the new counter keys appear in ``counters()`` for every stage tensor;
- ``set_models`` and ``rebuild`` drop the cache, and the stage builds
  reserve each model's largest bucket again;
- the cache's bookkeeping, with ``torch.cuda``'s graph, stream and pool
  replaced by a stand-in that records the aten ops a capture runs and runs
  them again on replay, writing into the tensors the capture made (as a
  graph rewrites its own memory): the first forward of a signature is eager,
  the second captures and replays, later ones replay; the replays equal
  eager forwards bit for bit, also once later replays of their graph have
  run (a replay returns a copy of the static output, which the next replay
  rewrites), a 20-step ``sample_dpm`` through the coarse forward's graph
  equals the eager one, the buckets of a model share one static
  buffer per input, a batch past it stays eager, captures run in the
  thread's own capture mode on one stream into one pool, each after the
  allocator's unused cache is given back, and the kernels' launch counters
  count a replay as an eager forward.

On the card (marked ``cuda``; the published widths of the three stage
models, random weights): a replayed forward equals the eager one bit for
bit for each model at two buckets in float32 and bf16, with the kernels'
launches counted alike; a 20-step ``sample_dpm`` through the coarse graph
equals the eager one; a fused world equals its staged twin on the wire with
graphs on; forward hooks, as the benchmark's trace puts on the models, fire
once per forward, their count equals ``forwards``, and later forwards
replay.

This file imports no JAX, so the card's tests run without the repository
conftest:
    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_graphs.py
"""
import contextlib
import functools
import gc
import os

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from terrain_diffusion_tpu_torch import use_full_f32
from terrain_diffusion_tpu_torch.nn.edm_unet import EDMUnet2D, EDMUnetConfig
from terrain_diffusion_tpu_torch.ops import cuda_lib
from terrain_diffusion_tpu_torch.ops import fused_block as fb
from terrain_diffusion_tpu_torch.pipeline.world import SCHED, SD, WorldPipeline
from terrain_diffusion_tpu_torch.runtime.cuda_graphs import ForwardGraphs, graph_key
from terrain_diffusion_tpu_torch.runtime.infinite_tensor import new_counts
from terrain_diffusion_tpu_torch.scheduler.dpmsolver import (compute_sigmas, sample_dpm,
                                                             trigflow_precondition_noise)
from terrain_diffusion_tpu_torch.training.registry import load_config

from test_torch_tracing import KW, MODEL_STAGES, QUERIES, _tiny_models

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COUNTER_KEYS = {"windows", "padded", "lookups", "hits", "forwards", "captures", "replays"}
# stage model -> the stage tensors whose forwards it runs
MODEL_COUNTS = {"coarse_model": ("coarse",), "base_model": ("latent_init", "latent_step"),
                "decoder_model": ("decoder",)}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op torch thread while this module runs: six pytest-xdist
    workers share the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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
    g = torch.Generator().manual_seed(20)
    return [_draw_gains(m, g) for m in _tiny_models()]


def _world(models, device="cpu", **kw):
    return WorldPipeline(device=device, **{**KW, **kw}).set_models(*models).bind()


def _inputs(g, n, shapes, dtype=torch.float32, device="cpu"):
    """Random (x, noise labels, cond) of batch n; ``shapes`` gives x's row
    shape and each cond tensor's."""
    x_shape, cond_shapes = shapes
    x = torch.randn((n, *x_shape), generator=g).to(device, dtype)
    nl = (torch.rand((n,), generator=g) * 1.5).to(device, dtype)
    cond = [torch.randn((n, *s), generator=g).to(device, dtype) for s in cond_shapes]
    return x, nl, cond


# tiny models: coarse (16 px, five float conds), base (64 px, one 58-vector), decoder
TINY_SHAPES = {"coarse": ((16, 16, 11), [()] * 5), "base": ((64, 64, 5), [(58,)]),
               "decoder": ((64, 64, 5), [])}


# --- the key ------------------------------------------------------------------

def test_graph_key_is_the_model_and_the_inputs_shapes_and_types(models):
    coarse, base, _ = models
    g = torch.Generator().manual_seed(0)
    a = _inputs(g, 4, TINY_SHAPES["coarse"])
    b = _inputs(g, 4, TINY_SHAPES["coarse"])  # other values, same bucket
    assert graph_key(coarse, *a) == graph_key(coarse, *b)
    assert graph_key(coarse, *a) == (id(coarse), ((4, 16, 16, 11), torch.float32),
                                     ((4,), torch.float32), (((4,), torch.float32),) * 5)
    assert graph_key(base, *a) != graph_key(coarse, *a)
    assert graph_key(coarse, *_inputs(g, 8, TINY_SHAPES["coarse"])) != graph_key(coarse, *a)
    assert graph_key(coarse, *_inputs(g, 4, TINY_SHAPES["coarse"], torch.bfloat16)) != \
        graph_key(coarse, *a)
    x, nl, cond = a
    assert graph_key(coarse, x, nl, cond[:4]) != graph_key(coarse, *a)


# --- a CPU world --------------------------------------------------------------

def _hook_counts(world):
    calls = {}
    hooks = [getattr(world, attr).register_forward_pre_hook(
        lambda _m, _a, attr=attr: calls.__setitem__(attr, calls.get(attr, 0) + 1))
        for attr in MODEL_COUNTS]
    return calls, hooks


def test_a_cpu_world_counts_every_forward_and_never_captures(models):
    world = _world(models)
    c0 = world.counters()
    assert set(c0) == set(MODEL_STAGES)
    for stage, c in c0.items():
        assert set(c) == COUNTER_KEYS, stage
        assert c["forwards"] == c["captures"] == c["replays"] == 0, stage
    calls, hooks = _hook_counts(world)
    try:
        for _ in range(2):  # the second pass computes nothing new
            world.get_many(QUERIES)
        world.get_many([(300, 300, 324, 324)])
    finally:
        for h in hooks:
            h.remove()
    c = world.counters()
    for attr, stages in MODEL_COUNTS.items():
        assert sum(c[s]["forwards"] for s in stages) == calls[attr] > 0, (attr, c, calls)
    for stage in MODEL_STAGES:
        assert c[stage]["captures"] == c[stage]["replays"] == 0, stage
    # 20 DPM steps a coarse batch; one forward a latent or decoder batch
    assert c["coarse"]["forwards"] % 20 == 0
    assert not world._graphs._graphs and not world._graphs._seen


def test_a_t1_world_counts_its_chain_under_latent_t1(models):
    world = _world(models, T=1)
    calls, hooks = _hook_counts(world)
    try:
        world.get_many(QUERIES[:1])
    finally:
        for h in hooks:
            h.remove()
    c = world.counters()
    assert set(c) == {"coarse", "latent_t1", "decoder"}
    assert all(set(v) == COUNTER_KEYS for v in c.values())
    # init and one step a window batch, both base forwards
    assert c["latent_t1"]["forwards"] == calls["base_model"] > 0
    assert c["latent_t1"]["replays"] == 0


def test_set_models_and_rebuild_drop_the_cache(models):
    world = _world(models)
    coarse, base, decoder = world.coarse_model, world.base_model, world.decoder_model
    assert world._graphs._rows == {id(coarse): 32, id(base): 4, id(decoder): 16}
    g = torch.Generator().manual_seed(1)
    counts = new_counts()
    with torch.no_grad():
        world._graphs(coarse, *_inputs(g, 2, TINY_SHAPES["coarse"]), counts)
    assert len(world._graphs._seen) == 1
    world.rebuild()
    assert not world._graphs._seen
    assert world._graphs._rows == {id(coarse): 32, id(base): 4, id(decoder): 16}
    with torch.no_grad():
        world._graphs(coarse, *_inputs(g, 2, TINY_SHAPES["coarse"]), counts)
    world.set_models(*_tiny_models())  # new weights: the graphs held the old ones
    assert not world._graphs._seen
    assert world._graphs._rows == {id(world.coarse_model): 32, id(world.base_model): 4,
                                   id(world.decoder_model): 16}
    assert id(world.coarse_model) != id(coarse)
    assert counts["captures"] == counts["replays"] == 0  # first forwards only: eager


# --- the cache's bookkeeping under a recording stand-in for the card ----------

class _Record(TorchDispatchMode):
    def __init__(self, ops):
        super().__init__()
        self.ops = ops

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        self.ops.append((func, args, kwargs, out))
        return out


def _tensors(out):
    return [t for t in (out if isinstance(out, (tuple, list)) else (out,))
            if isinstance(t, torch.Tensor)]


class RecordingGraph:
    """A CPU stand-in for ``torch.cuda.CUDAGraph``: the capture records the
    aten ops the forward runs and the tensors they make; a replay runs them
    again, each result written into the tensor its capture made, so a
    replay rewrites the same memory, as a graph does."""

    def __init__(self):
        self.ops, self.replays = [], 0
        self.pool = self.mode = self._rec = None

    def capture_begin(self, pool=None, capture_error_mode="global"):
        self.pool, self.mode = pool, capture_error_mode
        self._rec = _Record(self.ops)
        self._rec.__enter__()

    def capture_end(self):
        self._rec.__exit__(None, None, None)

    def replay(self):
        self.replays += 1
        for func, args, kwargs, out in self.ops:
            new = func(*args, **kwargs)
            for o, n in zip(_tensors(out), _tensors(new)):
                if o.untyped_storage().data_ptr() != n.untyped_storage().data_ptr():
                    o.copy_(n)  # a view or an in-place op has already written it


@pytest.fixture
def recorded(monkeypatch):
    """``torch.cuda``'s graph, pool, stream, stream context and cache release
    replaced by stand-ins that run on the CPU; yields the graphs, pools and
    streams made, and the number of graphs made at each cache release."""
    made = {"graphs": [], "pools": [], "streams": [], "emptied": []}

    def graph():
        made["graphs"].append(RecordingGraph())
        return made["graphs"][-1]

    def pool():
        made["pools"].append(object())
        return made["pools"][-1]

    def stream(device=None):
        made["streams"].append(device)
        return device

    monkeypatch.setattr(torch.cuda, "CUDAGraph", graph)
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", pool)
    monkeypatch.setattr(torch.cuda, "Stream", stream)
    monkeypatch.setattr(torch.cuda, "stream", lambda _s: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "empty_cache",
                        lambda: made["emptied"].append(len(made["graphs"])))
    return made


@pytest.mark.parametrize("name", ["coarse", "base", "decoder"])
def test_first_eager_then_capture_then_replays_equal_eager(models, recorded, name):
    model = dict(zip(("coarse", "base", "decoder"), models))[name]
    cache, counts = ForwardGraphs(), new_counts()
    cache.reserve(model, 4)
    g = torch.Generator().manual_seed(2)
    outs = []
    with torch.no_grad():
        for n in (2, 2, 2, 4, 2, 4, 4):
            x, nl, cond = _inputs(g, n, TINY_SHAPES[name])
            outs.append((model(x, nl, cond),
                         model(x, nl, cond, graphs=functools.partial(cache, counts=counts))))
    # every output kept, after the later replays of its graph
    for k, (want, got) in enumerate(outs):
        assert torch.equal(got, want), k
    # bucket 2: eager, capture + replay, replay, replay; bucket 4: eager, capture + replay, replay
    assert counts["captures"] == 2 and counts["replays"] == 5
    assert len(cache._graphs) == 2 and [gr.replays for gr in recorded["graphs"]] == [3, 2]
    assert all(gr.mode == "thread_local" for gr in recorded["graphs"])
    assert len(recorded["pools"]) == 1 and len(recorded["streams"]) == 1
    assert recorded["emptied"] == [0, 1]  # the cache given back before each capture
    assert {gr.pool for gr in recorded["graphs"]} == set(recorded["pools"])
    # one buffer per input at the reserved rows; the buckets take views of it
    (bufs,) = cache._buffers.values()
    assert [b.shape[0] for b in bufs] == [4] * (2 + len(TINY_SHAPES[name][1]))
    for graph in cache._graphs.values():
        for static, buf in zip(graph.inputs, bufs):
            assert static.data_ptr() == buf.data_ptr()


def test_a_batch_past_the_static_buffers_stays_eager(models, recorded):
    _, base, _ = models
    cache, counts = ForwardGraphs(), new_counts()
    cache.reserve(base, 2)
    g = torch.Generator().manual_seed(3)
    with torch.no_grad():
        for n in (2, 2, 4, 4, 4):
            x, nl, cond = _inputs(g, n, TINY_SHAPES["base"])
            assert torch.equal(cache(base, x, nl, cond, counts), base(x, nl, cond))
    assert counts["captures"] == 1 and counts["replays"] == 1 and len(cache._graphs) == 1


def test_sample_dpm_through_the_coarse_graph_equals_eager(models, recorded):
    """The coarse stage's 20-step sampler through one graph; its x0
    predictions of earlier steps are kept across later replays."""
    coarse = models[0]
    cache, counts = ForwardGraphs(), new_counts()
    cache.reserve(coarse, 4)
    g = torch.Generator().manual_seed(4)
    B = 3
    cond_img = torch.randn((B, 5, 16, 16), generator=g)
    x = torch.randn((B, 6, 16, 16), generator=g) * float(compute_sigmas(SCHED, 20)[0])
    scalars = [torch.full((B,), v) for v in (-1.2, 0.3, -0.7, 0.1, 0.9)]

    def model_fn(graphs):
        def fn(scaled, sigma):
            label = float(trigflow_precondition_noise(sigma, SD))
            x_in = torch.cat([scaled, cond_img], dim=1).permute(0, 2, 3, 1)
            out = coarse(x_in, torch.full((B,), label), scalars, graphs=graphs)
            return out.permute(0, 3, 1, 2).float()
        return fn

    with torch.no_grad():
        want = sample_dpm(model_fn(None), x, SCHED, 20)
        got = sample_dpm(model_fn(functools.partial(cache, counts=counts)), x, SCHED, 20)
    assert torch.equal(got, want)
    assert counts["captures"] == 1 and counts["replays"] == 19


def test_a_replay_counts_the_launches_it_captured(models, recorded, monkeypatch):
    """The plain CPU path launches no kernel: a forward that counts one
    launch of each wrapper stands in for the card's."""
    _, base, _ = models
    wrappers = (fb.fused_block, fb.conv3x3)
    real = type(base).forward

    def counting(self, *args, **kwargs):
        if kwargs.get("graphs") is None:
            for w in wrappers:
                cuda_lib.count_launch(w, torch.bfloat16)
        return real(self, *args, **kwargs)

    monkeypatch.setattr(type(base), "forward", counting)
    before = cuda_lib.launch_counts()
    totals = [w.launches for w in cuda_lib._COUNTED]
    cache, counts = ForwardGraphs(), new_counts()
    cache.reserve(base, 2)
    g = torch.Generator().manual_seed(5)
    try:
        with torch.no_grad():
            for _ in range(4):  # eager, capture + replay, replay, replay
                cache(base, *_inputs(g, 2, TINY_SHAPES["base"]), counts)
        since = cuda_lib.launches_since(before)
        for w, d, n in zip(cuda_lib._COUNTED, since, totals):
            assert d == ({torch.bfloat16: 4} if w in wrappers else {}), w
            assert w.launches == n + (4 if w in wrappers else 0), w
    finally:
        cuda_lib.add_launches(cuda_lib.launches_since(before), -1)
    assert cuda_lib.launches_since(before) == [{}] * len(before)
    assert [w.launches for w in cuda_lib._COUNTED] == totals
    assert counts["replays"] == 3


# --- on the card --------------------------------------------------------------

STAGE_CONFIGS = {"coarse": "configs/diffusion_coarse/diffusion_coarse.cfg",
                 "base": "configs/diffusion_base/diffusion_192-3.cfg",
                 "decoder": "configs/diffusion_decoder/diffusion_decoder_64-3.cfg"}
# the card's input rows: the serving path's map sizes and conditioning
CARD_SHAPES = {"coarse": ((64, 64, 11), [()] * 5), "base": ((64, 64, 5), [(58,)]),
               "decoder": ((512, 512, 5), [])}
CARD_BUCKETS = {"coarse": (1, 32), "base": (4, 64), "decoder": (1, 4)}


@pytest.fixture
def free_card():
    """Each card test starts with the memory of earlier tests' graph pools
    and cached blocks given back: a base forward at batch 64 in float32 holds
    21.5 GiB, and a cuDNN convolution short of workspace can fall back to
    another algorithm, which rounds otherwise."""
    gc.collect()
    torch.cuda.empty_cache()
    yield
    gc.collect()
    torch.cuda.empty_cache()


@pytest.fixture(scope="module")
def card_models():
    """The three stage models at their published widths, random weights (the
    gains drawn, so that no network is constant), on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    use_full_f32()
    g = torch.Generator().manual_seed(21)
    out = {}
    for name, rel in STAGE_CONFIGS.items():
        cfg = load_config(os.path.join(ROOT, rel))["model"]
        if name == "base":  # the JAX value that routes its attention to the kernel
            cfg["block_kwargs"] = {**cfg.get("block_kwargs", {}), "attention_impl": "pallas"}
        out[name] = _draw_gains(EDMUnet2D(EDMUnetConfig.from_dict(cfg), device="cuda",
                                          generator=g), g).eval()
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("name", ["coarse", "base", "decoder"])
def test_replay_equals_eager_on_the_card(card_models, free_card, name, dtype):
    model = card_models[name]
    cache, counts = ForwardGraphs(), new_counts()
    cache.reserve(model, max(CARD_BUCKETS[name]))
    g = torch.Generator().manual_seed(22)
    outs = []
    with torch.no_grad():
        for n in CARD_BUCKETS[name]:
            for call in range(4):  # eager, capture + replay, replay, replay
                x, nl, cond = _inputs(g, n, CARD_SHAPES[name], dtype, "cuda")
                before = cuda_lib.launch_counts()
                want = model(x, nl, cond)
                eager = cuda_lib.launches_since(before)
                before = cuda_lib.launch_counts()
                outs.append((want, cache(model, x, nl, cond, counts)))
                assert cuda_lib.launches_since(before) == eager, (n, call)
    for k, (want, got) in enumerate(outs):  # each kept across later replays
        assert got.dtype == want.dtype and torch.equal(got, want), k
    assert counts["captures"] == 2 and counts["replays"] == 6
    if name == "decoder":
        assert fb.fused_block.launches > 0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_sample_dpm_through_the_coarse_graph_on_the_card(card_models, free_card, dtype):
    coarse = card_models["coarse"]
    cache, counts = ForwardGraphs(), new_counts()
    cache.reserve(coarse, 32)
    g = torch.Generator().manual_seed(23)
    B = 8
    cond_img = torch.randn((B, 5, 64, 64), generator=g).cuda()
    x = (torch.randn((B, 6, 64, 64), generator=g) * float(compute_sigmas(SCHED, 20)[0])).cuda()
    scalars = [torch.full((B,), v, device="cuda", dtype=dtype) for v in (-1.2, 0.3, -0.7, 0.1, 0.9)]

    def model_fn(graphs):
        def fn(scaled, sigma):
            label = float(trigflow_precondition_noise(sigma, SD))
            x_in = torch.cat([scaled, cond_img], dim=1).permute(0, 2, 3, 1).to(dtype)
            out = coarse(x_in, torch.full((B,), label, device="cuda", dtype=dtype), scalars,
                         graphs=graphs)
            return out.permute(0, 3, 1, 2).float()
        return fn

    with torch.no_grad():
        want = sample_dpm(model_fn(None), x, SCHED, 20)
        got = sample_dpm(model_fn(functools.partial(cache, counts=counts)), x, SCHED, 20)
    assert torch.equal(got, want)
    assert counts["captures"] == 1 and counts["replays"] == 19


def _staged(world):
    """The same world on the staged path: no fused stage call, no fused
    compose (as ``test_torch_fused_world.py``'s twin)."""
    t = world.latents
    tensors = [world.residual, world.coarse]
    while t is not world.coarse:
        tensors.append(t)
        t = t.args[0]
    for t in tensors:
        t.f_fused = None
    world._compose_fused = lambda *a, **k: None
    return world


def _card_world(card_models, dtype, **kw):
    return WorldPipeline(seed=2026, device="cuda", dtype=dtype, **kw).set_models(
        card_models["coarse"], card_models["base"], card_models["decoder"]).bind()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [None, "bf16"], ids=["f32", "bf16"])
def test_fused_world_equals_staged_with_graphs_on_the_card(card_models, free_card, dtype):
    """The staged twin first, closed before the fused world is made: a
    world's graphs hold the memory of its largest forward until it closes,
    and two float32 worlds' do not fit on one card beside each other."""
    tiles = [(0, 0, 256, 256), (0, 256, 256, 512), (256, 0, 512, 256), (256, 256, 512, 512)]

    def serve(world):
        outs = [world.get(*q, pack_wire=True) for q in (tiles[0], tiles[0], tiles[1])]
        outs += world.get_many(tiles[2:], pack_wire=True)
        counts = world.counters()
        world.close()
        return outs, counts

    want, staged_counts = serve(_staged(_card_world(card_models, dtype)))
    got, fused_counts = serve(_card_world(card_models, dtype))
    for a, b in zip(got, want):
        assert a["elev"].tobytes() == b["elev"].tobytes()
        assert a["climate"].tobytes() == b["climate"].tobytes()
    for c in (staged_counts, fused_counts):
        assert sum(v["replays"] for v in c.values()) > 0, c


@pytest.mark.cuda
def test_hooks_fire_once_a_forward_and_later_forwards_replay(card_models, free_card):
    world = _card_world(card_models, "bf16")
    calls, hooks = _hook_counts(world)
    try:
        row = [(0, 256 * k, 256, 256 * (k + 1)) for k in range(4)]
        world.get_many(row[:2], pack_wire=True)
        first = world.counters()
        world.get_many(row[2:], pack_wire=True)
        world.get_many([(256, 256 * k, 512, 256 * (k + 1)) for k in range(2)], pack_wire=True)
    finally:
        for h in hooks:
            h.remove()
    c = world.counters()
    for attr, stages in MODEL_COUNTS.items():
        assert sum(c[s]["forwards"] for s in stages) == calls[attr] > 0, (attr, c, calls)
    assert first["coarse"]["replays"] > 0  # a batch's 20 DPM steps share a graph
    assert sum(v["replays"] for v in c.values()) > 0, c
    for v in c.values():
        assert v["captures"] <= v["replays"] <= v["forwards"], c
    world.close()
