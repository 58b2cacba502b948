"""The whole serving slice of the PyTorch port against the JAX package, on
the CPU: WorldPipeline.get and the /terrain wire format.

Both packages get the same tiny models (tests/helpers.py::tiny_models, with
nonzero gains so the networks are not constant), portable noise, decoder
tiles 64/48 and batch buckets [1, 2, 4].  Bars:
- relative RMSE < 1e-3 per output (elevation, climate): the BASELINE.md
  contract between implementations;
- /terrain: equal headers and payload size, int16 elevation within 1 m
  (floor can flip at an integer boundary), climate (float16 on the wire)
  within relative RMSE 2e-3 (1e-3 plus float16 rounding).
"""
import io
import json
import os
import subprocess
import sys
import textwrap

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from terrain_diffusion_tpu.pipeline.world import WorldPipeline as JaxWorldPipeline
from terrain_diffusion_tpu.serving import api as jax_api

from terrain_diffusion_tpu_torch.nn.edm_unet import EDMUnet2D, EDMUnetConfig
from terrain_diffusion_tpu_torch.nn.torch_compat import params_from_jax
from terrain_diffusion_tpu_torch.pipeline.world import WorldPipeline
from terrain_diffusion_tpu_torch.serving import api

from helpers import tiny_models

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KW = dict(seed=1234, latents_batch_size=[1, 2, 4], decoder_tile_size=64,
          decoder_tile_stride=48, noise_mode="portable")
QUERIES = [(0, 0, 24, 24), (8, -16, 32, 8)]


def _lively(tree):
    """Params with nonzero gains (init leaves them 0: constant networks)."""
    if not isinstance(tree, dict):
        return tree
    return {k: (jnp.asarray(0.3) if k == "emb_gain" else
                jnp.asarray(1.0) if k == "out_gain" else _lively(v))
            for k, v in tree.items()}


def _rrmse(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.sqrt(np.mean((got - want) ** 2)) / np.sqrt(np.mean(want ** 2)))


@pytest.fixture(scope="module")
def pipes():
    return _pipe_pair()


@pytest.mark.parametrize("query", QUERIES)
def test_get_matches_jax(pipes, query):
    port, ref = pipes
    got, want = port.get(*query), ref.get(*query)
    assert got["elev"].shape == want["elev"].shape
    assert got["climate"].shape == want["climate"].shape
    assert _rrmse(got["elev"], want["elev"]) < 1e-3
    assert _rrmse(got["climate"], want["climate"]) < 1e-3


def test_same_query_bit_identical(pipes):
    port, _ = pipes
    a, b = port.get(*QUERIES[0]), port.get(*QUERIES[0])
    np.testing.assert_array_equal(a["elev"], b["elev"])
    np.testing.assert_array_equal(a["climate"], b["climate"])


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


def test_terrain_endpoint_matches_jax(pipes):
    port, ref = pipes
    api.configure(pipeline=port)
    jax_api.configure(pipeline=ref)
    for path in ("/health", "/terrain?i1=0&j1=0&i2=24&j2=24",
                 "/terrain?i1=3&j1=-5&i2=19&j2=11&scale=2",  # supersampled
                 "/terrain?i1=0&j1=0", "/terrain?i1=5&j1=0&i2=1&j2=9"):
        got, want = _wsgi_get(api.app, path), _wsgi_get(jax_api.app, path)
        assert got[0] == want[0], path
        if not got[0].startswith("200") or path == "/health":
            assert json.loads(got[2]).keys() == json.loads(want[2]).keys()
            continue
        for h in ("X-Height", "X-Width", "Content-Type", "Content-Length"):
            assert got[1][h] == want[1][h], h
        h, w = int(got[1]["X-Height"]), int(got[1]["X-Width"])
        body, jbody = got[2], want[2]
        elev = np.frombuffer(body[:h * w * 2], "<i2").astype(np.int32)
        jelev = np.frombuffer(jbody[:h * w * 2], "<i2").astype(np.int32)
        assert np.max(np.abs(elev - jelev)) <= 1
        climate = np.frombuffer(body[h * w * 2:], "<f4")
        jclimate = np.frombuffer(jbody[h * w * 2:], "<f4")
        assert _rrmse(climate, jclimate) < 2e-3


def _pipe_pair(**kw):
    """(port, JAX) pipelines over the same lively tiny models; `kw` overrides
    KW (noise_mode, T, onestep_latent)."""
    models = [(m, _lively(p)) for m, p in tiny_models(decoder_tile=64)]
    port_models = []
    for m, p in models:
        pm = EDMUnet2D(EDMUnetConfig.from_dict(m.config.to_dict()), device="cpu",
                       generator=torch.Generator().manual_seed(0))
        pm.load_state_dict(params_from_jax(pm, p))
        port_models.append(pm)
    kw = {**KW, **kw}
    port = WorldPipeline(device="cpu", **kw).set_models(*port_models).bind()
    ref = JaxWorldPipeline(block_impl="xla", **kw).set_models(*models)
    ref.bind()
    return port, ref


STAGE_RANGES = {"coarse": [(0, 7), (-3, 5), (0, 6)],
                "latents": [(0, 6), (-8, 12), (0, 16)],
                "residual": [(0, 2), (-24, 40), (8, 56)]}


@pytest.fixture(scope="module")
def threefry_pipes():
    return _pipe_pair(noise_mode="threefry")


def test_default_pipeline_is_threefry_t2():
    """The JAX package's default world settings construct in the port."""
    pipe = WorldPipeline(seed=1, device="cpu")
    assert (pipe.noise_mode, pipe.T, pipe.onestep_latent) == ("threefry", 2, False)
    WorldPipeline(seed=1, device="cpu", T=1)
    WorldPipeline(seed=1, device="cpu", onestep_latent=True)


@pytest.mark.parametrize("stage", ["coarse", "latents", "residual"])
def test_threefry_stage_matches_jax(threefry_pipes, stage):
    port, ref = threefry_pipes
    with torch.no_grad():
        got = getattr(port, stage).read(STAGE_RANGES[stage]).numpy()
    want = np.asarray(getattr(ref, stage).read(STAGE_RANGES[stage]))
    assert got.shape == want.shape
    assert _rrmse(got, want) < 1e-3


@pytest.mark.parametrize("query", QUERIES)
def test_threefry_get_matches_jax(threefry_pipes, query):
    port, ref = threefry_pipes
    got, want = port.get(*query), ref.get(*query)
    assert _rrmse(got["elev"], want["elev"]) < 1e-3
    assert _rrmse(got["climate"], want["climate"]) < 1e-3


def test_threefry_noise_is_generated_per_batch_on_the_device(threefry_pipes, monkeypatch):
    """Each stage batch draws its noise in one call on the pipeline's
    device, with the JAX package's seed offsets: coarse seed and seed + 1,
    latent init seed + 5819, decoder seed + 15819."""
    from terrain_diffusion_tpu_torch.pipeline import world as world_mod

    port, _ = threefry_pipes
    calls = []
    real = world_mod.threefry_noise_batch

    def spy(seed, y0s, x0s, *a, **k):
        calls.append((int(seed) - port.seed, len(y0s)))
        return real(seed, y0s, x0s, *a, **k)

    monkeypatch.setattr(world_mod, "threefry_noise_batch", spy)

    def batches():
        return {k: v[0] for k, v in port.stage_timings.items()}

    before = batches()
    port.get(40000, 40000, 40016, 40016)  # far from cached tiles: every stage runs
    ran = {k: n - before.get(k, 0) for k, n in batches().items()}
    assert {off for off, _ in calls} == {0, 1, 5819, 5820, 15819}
    # one call per batch and stream: two in a coarse batch, one elsewhere
    assert len(calls) == (2 * ran["coarse"] + ran["latent_init"] + ran["latent_step"]
                          + ran["decoder"])


@pytest.mark.parametrize("variant", [{"T": 1}, {"onestep_latent": True}],
                         ids=["T1", "onestep"])
def test_latent_variants_match_jax(variant):
    port, ref = _pipe_pair(noise_mode="threefry", **variant)
    with torch.no_grad():
        got = port.latents.read(STAGE_RANGES["latents"]).numpy()
    want = np.asarray(ref.latents.read(STAGE_RANGES["latents"]))
    assert _rrmse(got, want) < 1e-3
    g, w = port.get(*QUERIES[0]), ref.get(*QUERIES[0])
    assert _rrmse(g["elev"], w["elev"]) < 1e-3
    assert _rrmse(g["climate"], w["climate"]) < 1e-3
    if variant.get("T") == 1:
        assert port.latents.tensor_id == "latent_map_T1"
    else:
        assert "latent_step" not in port.stage_timings


def test_get_many_is_byte_identical_to_sequential_get(threefry_pipes):
    """get_many: one generation pass over all queries, each composed as
    get() composes it; a fresh pipeline serving the queries one by one
    returns the same bytes."""
    port, _ = threefry_pipes
    queries = [(0, 0, 24, 24), (60, 0, 84, 24), (0, 60, 24, 84), (-30, -30, -6, -6)]
    fresh = WorldPipeline(device="cpu", **{**KW, "noise_mode": "threefry"}).set_models(
        port.coarse_model, port.base_model, port.decoder_model).bind()
    got = fresh.get_many(queries, pack_wire=True)
    for q, g in zip(queries, got):
        w = port.get(*q, pack_wire=True)
        assert g["elev"].tobytes() == w["elev"].tobytes(), q
        assert g["climate"].tobytes() == w["climate"].tobytes(), q


_STANDALONE = textwrap.dedent("""
    import json, sys, threading, urllib.request
    import torch
    from terrain_diffusion_tpu_torch.nn.edm_unet import EDMUnet2D, EDMUnetConfig
    from terrain_diffusion_tpu_torch.pipeline.world import WorldPipeline
    from terrain_diffusion_tpu_torch.serving import api

    g = torch.Generator().manual_seed(0)
    def unet(**kw):
        base = dict(model_channels=8, layers_per_block=1, attn_resolutions=(),
                    midblock_attention=False, concat_balance=0.5,
                    fourier_scale="pos", noise_emb_dims=8, logvar_channels=8)
        return EDMUnet2D(EDMUnetConfig(**base, **kw), device="cpu", generator=g)
    models = [
        unet(image_size=16, in_channels=11, out_channels=6, model_channel_mults=(1,),
             conditional_inputs=tuple(("float", 8, 0.2) for _ in range(5))),
        unet(image_size=64, in_channels=5, out_channels=5, model_channel_mults=(1, 2),
             conditional_inputs=(("tensor", 58, 1.0),)),
        unet(image_size=64, in_channels=5, out_channels=1, model_channel_mults=(1, 2)),
    ]
    pipe = WorldPipeline(seed=5, latents_batch_size=[1, 2, 4], decoder_tile_size=64,
                         decoder_tile_stride=48, noise_mode="portable", device="cpu")
    api.configure(pipeline=pipe.set_models(*models))
    httpd = api.app.make_server("127.0.0.1", 0, quiet=True)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    url = f"http://127.0.0.1:{httpd.server_address[1]}/terrain?i1=0&j1=0&i2=16&j2=16"
    with urllib.request.urlopen(url, timeout=300) as r:
        body = r.read()
        assert r.headers["X-Height"] == "16" and len(body) == 16 * 16 * 18
    httpd.shutdown()
    httpd.server_close()
    loaded = sorted(m for m in sys.modules
                    if m.split(".")[0] in ("jax", "jaxlib", "terrain_diffusion_tpu"))
    print(json.dumps(loaded))
""")


def test_port_serves_without_jax():
    """The port's CPU slice, served over a localhost socket in a fresh
    process, loads neither JAX nor the JAX package."""
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", _STANDALONE], capture_output=True,
                         text=True, timeout=300, env=env, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_from_pretrained_loads_a_saved_world(pipes, tmp_path):
    """The entry point's loading path: a world directory written by the JAX
    package (config.json + three reference-format model folders) serves the
    same terrain through the port."""
    pytest.importorskip("safetensors")
    _, ref = pipes
    ref.save_pretrained(str(tmp_path))
    port = WorldPipeline.from_pretrained(
        str(tmp_path), seed=KW["seed"], latents_batch_size=[1, 2, 4],
        noise_mode="portable", device="cpu").bind()
    got, want = port.get(*QUERIES[0]), ref.get(*QUERIES[0])
    assert _rrmse(got["elev"], want["elev"]) < 1e-3
    assert _rrmse(got["climate"], want["climate"]) < 1e-3


def test_save_pretrained_writes_the_world_both_packages_read(pipes, tmp_path):
    """A world directory written by the port has the JAX package's config
    keys and values, loads back into the port with the same weights and
    terrain, and loads into the JAX package."""
    pytest.importorskip("safetensors")
    port, ref = pipes
    port.save_pretrained(str(tmp_path))
    with open(tmp_path / "config.json") as f:
        assert json.load(f) == json.loads(json.dumps(ref.get_config()))
    back = WorldPipeline.from_pretrained(str(tmp_path), **KW, device="cpu").bind()
    for a, b in zip((port.coarse_model, port.base_model, port.decoder_model),
                    (back.coarse_model, back.base_model, back.decoder_model)):
        sa, sb = a.state_dict(), b.state_dict()
        assert sa.keys() == sb.keys() and all(torch.equal(sa[k], sb[k]) for k in sa)
    got, want = back.get(*QUERIES[0]), port.get(*QUERIES[0])
    assert np.array_equal(got["elev"], want["elev"])
    jax_world = JaxWorldPipeline.from_pretrained(str(tmp_path), block_impl="xla", **KW)
    jax_world.bind()
    assert _rrmse(jax_world.get(*QUERIES[0])["elev"], want["elev"]) < 1e-3
