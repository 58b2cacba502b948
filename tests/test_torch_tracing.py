"""The port's spans, stage clock and counters, on tiny CPU worlds.

- the runtime's counters: ``windows`` and ``padded`` rows of a request of a
  known number of windows under buckets (1, 4), staged and fused; lookups
  and hits of a repeated request;
- a repeated ``get_many`` hits on every lookup and computes no row, where a
  fresh world's first has no hit;
- the coalescer's counters against a stub world whose ``get_many`` sleeps;
- under ``WorldPipeline.profile``, ``td.get_many`` holds ``plan``, stage,
  ``fwd.*``, ``compose`` and ``fetch`` ranges, and its host time lies in
  its child ranges;
- without a profiler no ``record_function`` is made;
- ``stage_timings`` call counts of a fixed sequence of calls, as the
  synchronizing clock counted them;
- on a card (marked ``cuda``), with and without a mesh of two slots: a
  ``get_many`` calls ``torch.cuda.synchronize`` 0 times, and its stage
  seconds come from CUDA events.

This file imports no JAX, so the card's test runs without the repository
conftest:
    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_tracing.py
"""
import json
import threading
import time

import numpy as np
import pytest
import torch

from terrain_diffusion_tpu_torch.common import spans
from terrain_diffusion_tpu_torch.nn.edm_unet import EDMUnet2D, EDMUnetConfig
from terrain_diffusion_tpu_torch.parallel import Mesh
from terrain_diffusion_tpu_torch.pipeline.world import WorldPipeline
from terrain_diffusion_tpu_torch.runtime.infinite_tensor import InfiniteTensor
from terrain_diffusion_tpu_torch.runtime.tile_store import MemoryTileStore
from terrain_diffusion_tpu_torch.runtime.window import TensorWindow
from terrain_diffusion_tpu_torch.serving.coalesce import CoalescedPipeline, RequestCoalescer

KW = dict(seed=1234, latents_batch_size=[1, 2, 4], decoder_tile_size=64,
          decoder_tile_stride=48)
QUERIES = [(0, 0, 24, 24), (60, 0, 84, 24), (0, 60, 24, 84), (60, 60, 84, 84)]
MODEL_STAGES = ("coarse", "latent_init", "latent_step", "decoder")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op torch thread while this module runs: six pytest-xdist
    workers share the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tiny_models(device="cpu"):
    """Tiny coarse, base and decoder U-Nets with the production channel
    interfaces (``tests/helpers.py::tiny_models`` at decoder tile 64)."""
    common = dict(model_channels=8, layers_per_block=1, attn_resolutions=(),
                  midblock_attention=False, concat_balance=0.5, fourier_scale="pos",
                  noise_emb_dims=8, logvar_channels=8)
    cfgs = [
        EDMUnetConfig(image_size=16, in_channels=11, out_channels=6, model_channel_mults=(1,),
                      conditional_inputs=tuple(("float", 8, 0.2) for _ in range(5)), **common),
        EDMUnetConfig(image_size=64, in_channels=5, out_channels=5, model_channel_mults=(1, 2),
                      conditional_inputs=(("tensor", 58, 1.0),), **common),
        EDMUnetConfig(image_size=64, in_channels=5, out_channels=1, model_channel_mults=(1, 2),
                      conditional_inputs=(), **common),
    ]
    return [EDMUnet2D(c, device=device, generator=torch.Generator().manual_seed(k)).eval()
            for k, c in enumerate(cfgs)]


@pytest.fixture(scope="module")
def models():
    return _tiny_models()


def _world(models, **kw):
    return WorldPipeline(device="cpu", **{**KW, **kw}).set_models(*models).bind()


# --- the runtime's counters ---------------------------------------------------

def _flat_tensor(fused: bool):
    """A root tensor of 1x4x4 windows, stride 4 (no overlap), buckets (1, 4);
    with ``fused`` its chunks take the one-call path into its pool."""
    win = TensorWindow((1, 4, 4), (1, 4, 4))

    def f(ctxs):
        return torch.ones((len(ctxs), 1, 4, 4))

    def f_fused(ctxs, out_atlas, out_slots, arg_views):
        out_atlas.index_copy_(0, torch.as_tensor(np.asarray(out_slots, np.int64)),
                              f(ctxs)[:len(out_slots)])

    return InfiniteTensor(f, win, batch_buckets=(1, 4), tile_store=MemoryTileStore(),
                          tensor_id="t", device="cpu", shape=(1, None, None),
                          device_cache_tiles=16 if fused else 0, defer_host=fused,
                          f_fused=f_fused if fused else None)


@pytest.mark.parametrize("fused", [False, True], ids=["staged", "fused"])
def test_window_and_padding_counts_under_buckets_1_4(fused):
    t = _flat_tensor(fused)
    no_forwards = {"forwards": 0, "captures": 0, "replays": 0}  # a bare tensor runs no model
    region = [(0, 1), (0, 12), (0, 8)]  # 3 x 2 = 6 windows: chunks of 4 and 2 (+2 padding)
    t.ensure_region(region)
    assert t.counts == {"windows": 6, "padded": 2, "lookups": 6, "hits": 0, **no_forwards}
    t.ensure_region(region)
    assert t.counts == {"windows": 6, "padded": 2, "lookups": 12, "hits": 6, **no_forwards}
    t.ensure_region([(0, 1), (0, 4), (0, 4)])  # one resident window
    t.ensure_region([(0, 1), (12, 16), (0, 4)])  # one new window: bucket 1, no padding
    assert t.counts == {"windows": 7, "padded": 2, "lookups": 14, "hits": 7, **no_forwards}
    assert np.all(t[:, 0:16, 0:8] == 1.0)


def test_repeated_get_many_hits_every_lookup_and_computes_nothing(models):
    world = _world(models)
    assert set(world.counters()) == set(MODEL_STAGES)
    world.get_many(QUERIES)
    first = world.counters()
    for stage, c in first.items():
        assert c["hits"] == 0, (stage, c)
        assert c["windows"] > 0 and c["lookups"] >= c["windows"], (stage, c)
        assert 0 <= c["padded"] < c["windows"] * 4, (stage, c)
    world.get_many(QUERIES)
    second = world.counters()
    for stage in MODEL_STAGES:
        a, b = first[stage], second[stage]
        assert b["windows"] == a["windows"] and b["padded"] == a["padded"], stage
        assert b["hits"] - a["hits"] == b["lookups"] - a["lookups"], (stage, a, b)
    # the roots are found resident, so planning looks no deeper
    assert {s for s in MODEL_STAGES if second[s]["lookups"] > first[s]["lookups"]} == {
        "coarse", "latent_step", "decoder"}
    # the counters survive a rebuild, which makes new stage tensors
    world.rebuild()
    assert world.counters() == second


def test_counters_of_a_t1_world(models):
    world = _world(models, T=1)
    world.get_many(QUERIES[:1])
    c = world.counters()
    assert set(c) == {"coarse", "latent_t1", "decoder"}
    assert all(v["windows"] > 0 for v in c.values())


# --- the coalescer's counters -------------------------------------------------

class SleepyWorld:
    """A world whose ``get_many`` sleeps 0.2 s and then echoes its boxes."""

    def __init__(self):
        self.started = threading.Event()

    def get_many(self, queries, with_climate=True, pack_wire=False):
        self.started.set()
        time.sleep(0.2)
        return [{"elev": q} for q in queries]

    def close(self):
        pass


def test_coalescer_counts_queue_wait_batches_and_queries():
    world = SleepyWorld()
    pipe = CoalescedPipeline(world)
    c = pipe._coalescer
    assert c.counters() == {"jobs": 0, "queue_wait_s": 0.0, "batches": 0, "queries": 0,
                            "busy_s": 0.0}
    first = threading.Thread(target=lambda: c.get_terrain(0, 0, 8, 8))
    first.start()
    assert world.started.wait(timeout=10)
    # submitted while the first batch sleeps: waits until it ends
    assert c.get_terrain_boxes([(8, 0, 16, 8), (16, 0, 24, 8)]) == [
        {"elev": (8, 0, 16, 8)}, {"elev": (16, 0, 24, 8)}]
    first.join(timeout=10)
    assert not first.is_alive()
    got = pipe.coalescer_counters()
    pipe.close()
    assert got["jobs"] == 2 and got["batches"] == 2 and got["queries"] == 3, got
    assert got["queue_wait_s"] >= 0.15, got
    assert got["busy_s"] >= 0.4, got


def test_calls_are_not_terrain_jobs():
    c = RequestCoalescer(SleepyWorld())
    assert c.run(lambda w: 7) == 7
    got = c.counters()
    c.close()
    assert got["jobs"] == 0 and got["batches"] == 0, got


# --- spans ------------------------------------------------------------------

def _events(path):
    with open(path, encoding="utf-8") as f:
        trace = json.load(f)
    return [e for e in trace["traceEvents"] if e.get("ph") == "X"]


def test_profile_labels_every_part_of_get_many(models, tmp_path):
    world = _world(models)
    world.get_many([(200000, 200000, 200024, 200024)])  # warm, far from the profiled tiles
    with world.profile(str(tmp_path / "trace")):
        world.get_many(QUERIES)
    events = _events(tmp_path / "trace" / "trace.json")
    ranges = [e for e in events if e.get("cat") == "user_annotation"
              and e["name"].startswith(spans.PREFIX)]
    (gm,) = [e for e in ranges if e["name"] == "td.get_many"]
    g0, g1 = gm["ts"], gm["ts"] + gm["dur"]
    inside = [e for e in ranges if e is not gm and e.get("tid") == gm.get("tid")
              and g0 <= e["ts"] and e["ts"] + e["dur"] <= g1]
    names = {e["name"] for e in inside}
    for want in ("td.plan", "td.prefetch", "td.coarse", "td.latent_init", "td.latent_step",
                 "td.decoder", "td.compose", "td.copy", "td.fetch", "td.timings"):
        assert want in names, (want, sorted(names))
    fwd = sorted(n for n in names if n.startswith("td.fwd."))
    assert {n.split(".")[2] for n in fwd} == {"coarse", "base", "decoder"}, fwd
    assert "td.fwd.base.4.64.64" in fwd or "td.fwd.base.2.64.64" in fwd, fwd
    # the host time of get_many lies in its children: short gaps only, of
    # the statements between two ranges
    covered = []
    for e in sorted(inside, key=lambda e: e["ts"]):
        a, b = e["ts"], e["ts"] + e["dur"]
        if covered and a <= covered[-1][1]:
            covered[-1][1] = max(covered[-1][1], b)
        else:
            covered.append([a, b])
    edges = [g0] + [x for ab in covered for x in ab] + [g1]
    gaps = [b - a for a, b in zip(edges[::2], edges[1::2])]
    assert max(gaps) < 5000.0, gaps                  # microseconds
    assert sum(gaps) < 0.03 * gm["dur"], (sum(gaps), gm["dur"])


def test_no_range_is_made_without_a_profiler(models, monkeypatch):
    made = []
    real = torch.profiler.record_function

    def counting(name, *args, **kwargs):
        made.append(name)
        return real(name, *args, **kwargs)

    monkeypatch.setattr(torch.profiler, "record_function", counting)
    world = _world(models)
    world.get_many(QUERIES[:2])
    world.get(*QUERIES[2])
    assert made == []
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        world.get_many(QUERIES[3:])
    assert "td.get_many" in made


def test_verbose_log_prints_each_stage(models, capsys):
    world = _world(models, log_mode="verbose")
    world.get(*QUERIES[0])
    out = capsys.readouterr().out
    for stage in MODEL_STAGES + ("prefetch", "compose", "fetch"):
        assert f"[{stage}] " in out, (stage, out)


# --- stage_timings ------------------------------------------------------------

# Calls of each stage in the sequence below, as the synchronizing clock
# counted them before stage times came from CUDA events.
SEQUENCE_CALLS = {"coarse": 1, "latent_init": 11, "latent_step": 5, "decoder": 4,
                  "prefetch": 4, "compose": 4, "fetch": 4}


def test_stage_call_counts_of_a_fixed_sequence(models):
    world = _world(models)
    world.get(*QUERIES[0])
    world.get_many(QUERIES)
    world.get_many([(100, 100, 124, 124), (200, 40, 224, 64)])
    world.get(300, 300, 331, 317, with_climate=False)
    calls = {k: v[0] for k, v in world.stage_timings.items()}
    assert calls == SEQUENCE_CALLS
    assert all(v[1] > 0 for v in world.stage_timings.values())
    summary = world.timing_summary()
    assert summary["decoder"]["calls"] == SEQUENCE_CALLS["decoder"]


# --- on the card --------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("slots", [0, 2], ids=["no_mesh", "mesh2"])
def test_get_many_on_the_card_synchronizes_nothing(slots, monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    mesh = Mesh.from_devices(["cuda:0"] * slots) if slots else None
    world = WorldPipeline(device="cuda", block_impl="xla", mesh=mesh, **KW).set_models(
        *_tiny_models("cuda")).bind()
    world.get_many([(200000, 200000, 200024, 200024)])  # first CUDA work, far away
    before = {k: list(v) for k, v in world.stage_timings.items()}
    syncs = []
    real = torch.cuda.synchronize
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda *a, **k: (syncs.append(a), real(*a, **k))[1])
    t0 = time.perf_counter()
    out = world.get_many(QUERIES)
    wall = time.perf_counter() - t0
    assert syncs == []
    assert all(r["elev"].shape == (24, 24) for r in out)
    delta = {k: (v[0] - before.get(k, [0, 0.0])[0], v[1] - before.get(k, [0, 0.0])[1])
             for k, v in world.stage_timings.items()}
    for stage in MODEL_STAGES + ("compose",):
        assert delta[stage][0] > 0 and delta[stage][1] > 0, (stage, delta)
    # prefetch holds the model stages; the rest follow one another on the stream
    assert sum(s for k, (_, s) in delta.items() if k != "prefetch") <= wall, (delta, wall)
    assert delta["prefetch"][1] <= wall
