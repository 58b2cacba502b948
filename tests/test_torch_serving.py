"""The port's Minecraft terrain server, request coalescing and threaded HTTP
serving, against the JAX package on the CPU.

The Minecraft parity tests give both packages the same tiny models (the
base model with midblock attention built with attention_impl="pallas", so
the slice's attention route runs) and the default world settings: threefry
noise, T=2.  Bars:
- binary /terrain: equal status, headers and payload size; int16 elevation
  within 1 m (floor can flip at an integer boundary); biome ids equal on at
  least 99% of pixels (a rule threshold can flip where the two packages'
  climate differs in the last bits);
- format=json: the same keys and shape, elevation within 1 m;
- the biome classifier and climate variables: bit-equal (NumPy on both
  sides);
- concurrent, coalesced requests: byte-identical to sequential ones.

The coalescer cases mirror tests/test_coalesce.py on the port.
"""
import io
import json
import socket
import threading
import time
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from terrain_diffusion_tpu.common import cli_helpers as jcli
from terrain_diffusion_tpu.nn import EDMUnet2D as JaxEDMUnet2D
from terrain_diffusion_tpu.nn import EDMUnetConfig as JaxEDMUnetConfig
from terrain_diffusion_tpu.pipeline.world import WorldPipeline as JaxWorldPipeline
from terrain_diffusion_tpu.serving import minecraft_api as jmc

from terrain_diffusion_tpu_torch.common import cli_helpers
from terrain_diffusion_tpu_torch.nn.edm_unet import EDMUnet2D, EDMUnetConfig
from terrain_diffusion_tpu_torch.nn.torch_compat import params_from_jax
from terrain_diffusion_tpu_torch.pipeline.world import WorldPipeline
from terrain_diffusion_tpu_torch.serving import api, minecraft_api as mc
from terrain_diffusion_tpu_torch.serving.coalesce import CoalescedPipeline, RequestCoalescer
from terrain_diffusion_tpu_torch.serving.httpd import App, jsonify

from helpers import tiny_models

KW = dict(seed=4321, latents_batch_size=[1, 2, 4], decoder_tile_size=64,
          decoder_tile_stride=48)
BASE_BLOCK_KWARGS = {"channels_per_head": 8, "attention_impl": "pallas"}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op torch thread while this module runs: six pytest-xdist
    workers share the CPU, and torch's default of a thread per core makes
    each small op wait on descheduled siblings."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _wsgi_get(app, path):
    from urllib.parse import urlsplit

    parts = urlsplit(path)
    environ = {"REQUEST_METHOD": "GET", "PATH_INFO": parts.path,
               "QUERY_STRING": parts.query, "wsgi.input": io.BytesIO(b""),
               "CONTENT_LENGTH": "0"}
    out = {}

    def start_response(status, headers):
        out["status"], out["headers"] = status, dict(headers)

    body = b"".join(app.wsgi(environ, start_response))
    return out["status"], out["headers"], body


def _lively(tree):
    if not isinstance(tree, dict):
        return tree
    return {k: (jnp.asarray(0.3) if k == "emb_gain" else
                jnp.asarray(1.0) if k == "out_gain" else _lively(v))
            for k, v in tree.items()}


def _models():
    """(JAX (model, params), port module) triples: tiny coarse and decoder,
    and a tiny base whose midblock (32x32 on 64 px latents, 2 heads) has
    attention with attention_impl="pallas"."""
    (coarse, decoder) = [m for i, m in enumerate(tiny_models(decoder_tile=64)) if i != 1]
    base = JaxEDMUnet2D(JaxEDMUnetConfig(
        image_size=64, in_channels=5, out_channels=5, model_channels=8,
        model_channel_mults=(1, 2), layers_per_block=1, attn_resolutions=(),
        midblock_attention=True, concat_balance=0.5,
        conditional_inputs=(("tensor", 58, 1.0),), fourier_scale="pos",
        noise_emb_dims=8, logvar_channels=8, block_kwargs=BASE_BLOCK_KWARGS))
    jax_models = [(m, _lively(p)) for m, p in
                  (coarse, (base, base.init(jax.random.key(11))), decoder)]
    port_models = []
    for m, p in jax_models:
        d = m.config.to_dict()
        if m is base:
            d["block_kwargs"] = BASE_BLOCK_KWARGS
        pm = EDMUnet2D(EDMUnetConfig.from_dict(d), device="cpu",
                       generator=torch.Generator().manual_seed(0))
        pm.load_state_dict(params_from_jax(pm, p))
        port_models.append(pm)
    return jax_models, port_models


@pytest.fixture(scope="module")
def models():
    return _models()


def _port_pipe(models, **kw):
    return WorldPipeline(device="cpu", **{**KW, **kw}).set_models(*models[1]).bind()


@pytest.fixture(scope="module")
def pipes(models):
    ref = JaxWorldPipeline(block_impl="xla", **KW).set_models(*models[0])
    ref.bind()
    return _port_pipe(models), ref


# --- the Minecraft server against the JAX one -------------------------------

MC_PATHS = [
    "/terrain?i1=0&j1=0&i2=24&j2=24",
    "/terrain?i1=0&j1=0&i2=24&j2=24&format=json",
    "/terrain?i1=3&j1=-5&i2=27&j2=19&scale=4",
    "/terrain?i1=3&j1=-5&i2=27&j2=19&scale=4&noise=0.5&format=json",
    "/90?i1=8&j1=-16&i2=32&j2=8",
    "/22?i1=-8&j1=4&i2=8&j2=20",
]


@pytest.mark.parametrize("path", MC_PATHS)
def test_minecraft_terrain_matches_jax(pipes, path):
    port, ref = pipes
    mc.configure(pipeline=port)
    jmc.configure(pipeline=ref)
    got, want = _wsgi_get(mc.app, path), _wsgi_get(jmc.app, path)
    assert got[0] == want[0] and got[0].startswith("200"), (got[0], want[0])
    if "format=json" in path:
        g, w = json.loads(got[2]), json.loads(want[2])
        assert g.keys() == w.keys() and g["shape"] == w["shape"]
        assert g["dtype"] == w["dtype"] == "float32"
        assert np.max(np.abs(np.asarray(g["elev"]) - np.asarray(w["elev"]))) <= 1.0
        return
    for h in ("X-Height", "X-Width", "Content-Type", "Content-Length"):
        assert got[1][h] == want[1][h], h
    h, w = int(got[1]["X-Height"]), int(got[1]["X-Width"])
    assert len(got[2]) == h * w * 4
    elev = np.frombuffer(got[2][:h * w * 2], "<i2").astype(np.int32)
    jelev = np.frombuffer(want[2][:h * w * 2], "<i2").astype(np.int32)
    assert np.max(np.abs(elev - jelev)) <= 1
    biome = np.frombuffer(got[2][h * w * 2:], "<i2")
    jbiome = np.frombuffer(want[2][h * w * 2:], "<i2")
    assert np.mean(biome == jbiome) >= 0.99
    assert elev.std() > 0  # not a constant world


def test_minecraft_health_and_errors_match_jax(pipes):
    port, ref = pipes
    mc.configure(pipeline=port)
    jmc.configure(pipeline=ref)
    for path in ("/health", "/terrain?i1=0&j1=0", "/terrain?i1=5&j1=0&i2=1&j2=9",
                 "/terrain?i1=0&j1=0&i2=4&j2=4&scale=0", "/45?i1=0&j1=0&i2=4"):
        got, want = _wsgi_get(mc.app, path), _wsgi_get(jmc.app, path)
        assert got[0] == want[0], path
        assert json.loads(got[2]).keys() == json.loads(want[2]).keys(), path
    assert json.loads(_wsgi_get(mc.app, "/health")[2]) == {"status": "ok"}


def test_biome_classifier_and_climate_vars_bit_equal(rng):
    h, w = 40, 48
    elev = rng.uniform(-800, 3500, (h, w)).astype(np.float32)
    elev_padded = np.pad(elev, 1, mode="reflect") * 1.01
    climate = np.stack([rng.uniform(-20, 32, (h, w)), rng.uniform(50, 1500, (h, w)),
                        rng.uniform(0, 3000, (h, w)),
                        rng.uniform(0, 150, (h, w))]).astype(np.float32)
    for px in (90.0, 22.5):
        np.testing.assert_array_equal(
            mc.classify_biome(elev, climate, -17, 33, elev_padded, px),
            jmc.classify_biome(elev, climate, -17, 33, elev_padded, px))
    got = mc.compute_climate_vars(*climate)
    want = jmc.compute_climate_vars(*climate)
    assert got.keys() == want.keys()
    for k in got:
        np.testing.assert_array_equal(got[k], want[k])
    assert (mc.classify_biome(elev, None, 0, 0, elev_padded) == mc.BIOME_ID["plains"]).all()


def test_cli_helpers_match_jax():
    for v in ("100M", "1G", "500K", "1.5G", "64", None):
        assert cli_helpers.parse_cache_size(v) == jcli.parse_cache_size(v)
    with pytest.raises(ValueError):
        cli_helpers.parse_cache_size("lots")
    items = ("noise_mode=portable", "T=1", "cond_snr=[0.3, 0.1]", "name=x=y")
    assert cli_helpers.parse_kwargs(items) == jcli.parse_kwargs(items)
    assert cli_helpers.parse_batch_sizes("1,4") == [1, 4]
    assert cli_helpers.parse_batch_sizes("8") == 8


# --- coalescing on the real port pipeline -----------------------------------

def test_concurrent_coalesced_requests_match_sequential(models):
    """Four adjacent tiles from four threads through a CoalescedPipeline:
    the same bytes as the tiles served one by one by a plain pipeline, in
    fewer stage batches."""
    tiles = [(0, 0, 24, 24), (0, 24, 24, 48), (24, 0, 48, 24), (24, 24, 48, 48)]
    seq = _port_pipe(models)
    want = [seq.get(*t, pack_wire=True) for t in tiles]
    world = _port_pipe(models)
    co = CoalescedPipeline(world)
    got = [None] * len(tiles)

    def client(k):
        got[k] = co.get(*tiles[k], pack_wire=True)

    threads = [threading.Thread(target=client, args=(k,)) for k in range(len(tiles))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    co.close()
    for w, g in zip(want, got):
        assert g["elev"].tobytes() == w["elev"].tobytes()
        assert g["climate"].tobytes() == w["climate"].tobytes()

    def batches(p):
        return sum(v[0] for k, v in p.stage_timings.items()
                   if k in ("coarse", "latent_init", "latent_step", "decoder"))

    assert batches(world) <= batches(seq)


def test_empty_cache_recomputes_the_same_bytes(models):
    """empty_cache (a coalescer mutator) drops every cached window: the
    repeat runs the stages again and gives the same bytes."""
    co = CoalescedPipeline(_port_pipe(models))
    first = co.get(0, 0, 16, 16, pack_wire=True)
    decoder_calls = co.stage_timings["decoder"][0]
    co.get(0, 0, 16, 16, pack_wire=True)
    assert co.stage_timings["decoder"][0] == decoder_calls  # served from the cache
    co.empty_cache()
    again = co.get(0, 0, 16, 16, pack_wire=True)
    assert co.stage_timings["decoder"][0] > decoder_calls
    co.close()
    assert again["elev"].tobytes() == first["elev"].tobytes()
    assert again["climate"].tobytes() == first["climate"].tobytes()


def test_per_request_seed_on_the_real_pipeline(models):
    """A coalesced request with ?seed= gets that seed's world, equal to a
    plain pipeline built with the seed."""
    co = CoalescedPipeline(_port_pipe(models))
    got = co.get(0, 0, 16, 16, seed=99)
    assert co.seed == 99
    co.close()
    want = _port_pipe(models, seed=99).get(0, 0, 16, 16)
    assert got["elev"].tobytes() == want["elev"].tobytes()


def test_threaded_minecraft_server_over_sockets(models):
    """The Minecraft server in threaded (coalesced) mode on a localhost
    port: concurrent chunk requests answer with the bytes the
    single-threaded WSGI path gives for the same world."""
    paths = [f"/terrain?i1={i}&j1={j}&i2={i + 16}&j2={j + 16}"
             for i in (0, 16) for j in (0, 16)]
    mc.configure(pipeline=_port_pipe(models))
    want = [_wsgi_get(mc.app, p)[2] for p in paths]
    mc.configure(pipeline=_port_pipe(models), coalesce=True)
    world = mc._get_pipeline()
    assert isinstance(world, CoalescedPipeline)
    httpd = mc.app.make_server("127.0.0.1", 0, quiet=True, threaded=True,
                               serialize=False)
    assert httpd.mode == "threaded (coalesced pipeline)"
    server = threading.Thread(target=httpd.serve_forever, daemon=True)
    server.start()
    port = httpd.server_address[1]
    got = [None] * len(paths)

    def client(k):
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{paths[k]}",
                                    timeout=300) as r:
            got[k] = r.read()

    try:
        threads = [threading.Thread(target=client, args=(k,)) for k in range(len(paths))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
    finally:
        httpd.shutdown()
        httpd.server_close()
        server.join(timeout=60)
        world.close()
        mc.configure()
    assert got == want


def test_minecraft_main_serves_a_saved_world(models, tmp_path):
    """The entry point as a user runs it: ``minecraft_api.main`` on a world
    directory, threaded, on a localhost port, answers with the bytes the
    in-process pipeline gives for the same world."""
    pytest.importorskip("safetensors")
    _port_pipe(models).save_pretrained(str(tmp_path))
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    argv = [str(tmp_path), "--device", "cpu", "--threaded", "--warmup", "--host",
            "127.0.0.1", "--port", str(port), "--seed", str(KW["seed"]),
            "--batch-size", "1,2,4", "--log-mode", "info", "--kwarg", "decoder_tile_size=64",
            "--kwarg", "decoder_tile_stride=48"]
    server = threading.Thread(target=mc.main, args=(argv,), daemon=True)
    server.start()
    path = "/terrain?i1=5&j1=-7&i2=21&j2=9"
    deadline = time.time() + 300
    while mc.app.server is None:
        assert server.is_alive() and time.time() < deadline
        time.sleep(0.05)
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=300) as r:
            got = r.read()
        world = mc._get_pipeline()
        assert isinstance(world, CoalescedPipeline) and world.noise_mode == "threefry"
        assert world.stage_timings["prefetch"][0] >= 3  # the warm-up tiles
    finally:
        mc.app.server.shutdown()
        server.join(timeout=60)
        mc._get_pipeline().close()
    assert not server.is_alive() and mc.app.server is None
    mc.configure(pipeline=_port_pipe(models))
    assert got == _wsgi_get(mc.app, path)[2]
    mc.configure()


def test_warmup_serves_three_tiles(models):
    pipe = _port_pipe(models)
    out = pipe.warmup(tile=16)
    assert set(out) == {"warmup_s"} and out["warmup_s"] >= 0
    assert pipe.stage_timings["prefetch"][0] == 3
    assert pipe.stage_timings["decoder"][0] > 0


# --- threaded HTTP modes -----------------------------------------------------

@pytest.mark.parametrize("threaded,serialize,mode", [
    (False, True, "single-threaded"), (True, True, "threaded (serialized pipeline)"),
    (True, False, "threaded (coalesced pipeline)")])
def test_make_server_modes(threaded, serialize, mode):
    """Two slow requests at once: a serialized server runs one handler at a
    time, a coalescing server runs them together."""
    app = App("modes")
    active, peak, lock = [0], [0], threading.Lock()

    @app.get("/slow")
    def slow(req):
        with lock:
            active[0] += 1
            peak[0] = max(peak[0], active[0])
        time.sleep(0.3)
        with lock:
            active[0] -= 1
        return jsonify({"ok": True})

    httpd = app.make_server("127.0.0.1", 0, quiet=True, threaded=threaded,
                            serialize=serialize)
    assert httpd.mode == mode
    server = threading.Thread(target=httpd.serve_forever, daemon=True)
    server.start()
    port = httpd.server_address[1]

    def client():
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/slow", timeout=30) as r:
            assert json.loads(r.read()) == {"ok": True}

    try:
        threads = [threading.Thread(target=client) for _ in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
    finally:
        httpd.shutdown()
        httpd.server_close()
        server.join(timeout=30)
    assert peak[0] == (2 if threaded and not serialize else 1)


# --- coalescer semantics on a fake world (mirrors tests/test_coalesce.py) ----

class FakeWorld:
    """Records every pipeline touch with the calling thread; slow prefetch
    so concurrent submissions pile up behind the first batch."""

    def __init__(self, prefetch_s: float = 0.05):
        self.seed = 42
        self.tile_store = object()
        self.native_resolution = 90.0
        self.prefetch_s = prefetch_s
        self.prefetch_batches = []
        self.get_calls = []
        self.touch_threads = set()
        self.closed = False

    def prefetch(self, queries, with_climate=True):
        self.touch_threads.add(threading.current_thread().name)
        self.prefetch_batches.append(list(queries))
        time.sleep(self.prefetch_s)

    def get_many(self, queries, with_climate=True, pack_wire=False):
        self.prefetch(queries, with_climate)
        return [self.get(*q, with_climate=with_climate, pack_wire=pack_wire)
                for q in queries]

    def get(self, i1, j1, i2, j2, with_climate=True, pack_wire=False):
        self.touch_threads.add(threading.current_thread().name)
        self.get_calls.append((i1, j1, i2, j2, pack_wire))
        elev = np.full((i2 - i1, j2 - j1), float(i1 * 1000 + j1), np.float32)
        if pack_wire:
            elev = elev.astype(np.int16)
        return {"elev": elev,
                "climate": np.zeros((5, i2 - i1, j2 - j1),
                                    np.float16 if pack_wire else np.float32)
                if with_climate else None}

    def change_seed(self, seed=None):
        self.touch_threads.add(threading.current_thread().name)
        if seed == self.seed:
            return False
        self.seed = seed
        return True

    def close(self):
        self.closed = True


def _run_clients(fn, n):
    threads = [threading.Thread(target=fn, args=(k,)) for k in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=10)


def test_concurrent_requests_coalesce_into_shared_batches():
    world = FakeWorld(prefetch_s=0.2)
    c = RequestCoalescer(world, max_batch=16)
    results = {}
    _run_clients(lambda k: results.__setitem__(k, c.get_terrain(k, 0, k + 8, 8)), 4)
    c.close()
    for k in range(4):
        assert results[k]["elev"][0, 0] == k * 1000
    assert len(world.prefetch_batches) < 4, world.prefetch_batches
    assert max(len(b) for b in world.prefetch_batches) >= 2
    assert world.touch_threads == {"pipeline-coalescer"}


def test_mutators_run_solo_on_worker_thread():
    world = FakeWorld(prefetch_s=0.0)
    p = CoalescedPipeline(world)
    assert p.seed == 42
    assert p.change_seed(7) is True and p.seed == 7
    assert p.change_seed(7) is False
    assert p.get(0, 0, 4, 4)["elev"].shape == (4, 4)
    outs = p.get_many([(0, 0, 4, 4), (8, 0, 12, 4)])
    assert len(outs) == 2 and outs[1]["elev"][0, 0] == 8000
    assert world.touch_threads == {"pipeline-coalescer"}
    p.close()
    assert world.closed


def test_errors_propagate_to_the_caller():
    world = FakeWorld()
    c = RequestCoalescer(world)

    def boom(w):
        raise ValueError("nope")

    with pytest.raises(ValueError, match="nope"):
        c.run(boom)
    world.prefetch = lambda *a, **k: (_ for _ in ()).throw(RuntimeError("gen"))
    world.get = lambda *a, **k: (_ for _ in ()).throw(RuntimeError("gen"))
    with pytest.raises(RuntimeError, match="gen"):
        c.get_terrain(0, 0, 4, 4)
    c.close()


def test_get_many_failure_falls_back_per_job():
    world = FakeWorld(prefetch_s=0.0)
    world.get_many = lambda *a, **k: (_ for _ in ()).throw(RuntimeError("gm"))
    c = RequestCoalescer(world)
    assert c.get_terrain(3, 0, 7, 4)["elev"][0, 0] == 3000.0
    c.close()


def test_per_request_seed_is_atomic():
    world = FakeWorld(prefetch_s=0.05)
    seeds_at_get = []
    orig_get = world.get

    def record_get(*a, **k):
        seeds_at_get.append(world.seed)
        return orig_get(*a, **k)

    world.get = record_get
    c = RequestCoalescer(world)
    _run_clients(lambda k: c.get_terrain(k, 0, k + 4, 4, seed=100 + k), 4)
    c.close()
    assert sorted(seeds_at_get) == [100, 101, 102, 103], seeds_at_get


def test_multi_box_job_served_under_one_seed():
    world = FakeWorld(prefetch_s=0.0)
    c = RequestCoalescer(world)
    outs = c.get_terrain_boxes([(0, 0, 4, 4), (4, 0, 8, 4)], seed=7)
    assert len(outs) == 2 and world.seed == 7
    c.close()


@pytest.mark.parametrize("server", [api, mc], ids=["api", "minecraft_api"])
def test_threaded_mode_uses_coalesced_pipeline(server):
    world = FakeWorld()
    server.configure(pipeline=world, coalesce=True)
    p = server._get_pipeline()
    assert isinstance(p, CoalescedPipeline)
    assert p.seed == 42 and p.native_resolution == 90.0
    assert p.get(0, 0, 4, 4)["elev"].shape == (4, 4)
    p.close()
    server.configure()


def test_close_races_with_inflight_jobs():
    world = FakeWorld(prefetch_s=0.15)
    c = RequestCoalescer(world, max_batch=16)
    results, errors = {}, {}

    def client(k):
        try:
            results[k] = c.get_terrain(k, 0, k + 4, 4)
        except Exception as e:  # noqa: BLE001
            errors[k] = e

    threads = [threading.Thread(target=client, args=(k,)) for k in range(3)]
    for t in threads:
        t.start()
    time.sleep(0.02)
    c.close()
    for t in threads:
        t.join(timeout=10)
    assert len(results) == 3 and not errors
    assert not c._thread.is_alive()
    with pytest.raises(RuntimeError):
        c.get_terrain(0, 0, 4, 4)


def test_pack_wire_flows_through_facade():
    world = FakeWorld(prefetch_s=0.0)
    p = CoalescedPipeline(world)
    assert p.get(0, 0, 4, 4, pack_wire=True)["elev"].dtype == np.int16
    assert world.get_calls[-1][-1] is True
    assert p.get_many([(0, 0, 4, 4)], pack_wire=True)[0]["elev"].dtype == np.int16
    p.close()


def test_minecraft_scale1_uses_one_atomic_job():
    """On a coalesced pipeline the padded and plain boxes of a scale-1
    request travel as one job under the request's seed."""
    world = FakeWorld(prefetch_s=0.0)
    mc.configure(pipeline=world, coalesce=True)
    status, headers, body = _wsgi_get(mc.app, "/terrain?i1=0&j1=0&i2=8&j2=8&seed=5")
    assert status.startswith("200") and headers["X-Height"] == "8"
    assert world.seed == 5
    assert world.prefetch_batches[-1] == [(-1, -1, 9, 9), (0, 0, 8, 8)]
    mc._get_pipeline().close()
    mc.configure()
