"""Terrain Explorer web app of the PyTorch port, the ``explore`` command
(counterpart of ``terrain_diffusion_tpu.serving.explorer.server``, the same
routes and page):

- ``GET /``                      static explorer page
- ``GET /api/status``            seed + channel names + native resolution
- ``POST /api/seed`` / ``POST /api/new_seed``
- ``GET /api/coarse.png``        per-channel viridis render with optional
  per-channel min/max filters (dimmed outside range), X-Vmin/X-Vmax headers
- ``GET /api/coarse_data.json``  all channel values for hover lookup
- ``GET /api/coarse_stats``      per-channel min/max
- ``GET /api/detail.png``        relief / elevation / temperature render of a
  clicked coarse cell (full 3-stage generation)
- ``GET /api/detail_raw``        int16 elev + f32 temperature binary

The detail routes run ``world.get``, whose decoder stage takes the CUDA
kernels on the card.

Run:
    python -m terrain_diffusion_tpu_torch explore <world_dir> [--threaded]
"""
from __future__ import annotations

import io
import os

import click
import numpy as np

from terrain_diffusion_tpu_torch.common.cli_helpers import (click_check_device,
                                                           parse_batch_sizes,
                                                           parse_cache_size, parse_kwargs)
from terrain_diffusion_tpu_torch.serving.httpd import App, Response, jsonify
from terrain_diffusion_tpu_torch.serving.relief_map import get_relief_map

app = App("terrain-explorer")

_PIPELINE = None
_PIPELINE_CONFIG: dict = {}

CHANNEL_NAMES = ["Elev", "p5", "Temp", "T std", "Precip", "Precip CV"]
_STATIC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "static")


def _get_pipeline():
    global _PIPELINE
    if _PIPELINE is not None:
        return _PIPELINE
    from terrain_diffusion_tpu_torch.pipeline.world import WorldPipeline

    cfg = _PIPELINE_CONFIG
    caching_strategy = cfg.get("caching_strategy", "direct")
    if cfg.get("pipeline") is not None:
        _PIPELINE = cfg["pipeline"]
    else:
        _PIPELINE = WorldPipeline.from_pretrained(
            cfg.get("model_path"),
            seed=cfg.get("seed"),
            latents_batch_size=cfg.get("latents_batch_size", [1, 2, 4, 8, 16]),
            log_mode=cfg.get("log_mode", "verbose"),
            dtype=cfg.get("dtype"),
            caching_strategy=caching_strategy,
            cache_limit=cfg.get("cache_limit"),
            device=cfg.get("device", "cuda"),
            **cfg.get("kwargs", {}),
        )
    if _PIPELINE.tile_store is None:
        hdf5_file = cfg.get("hdf5_file")
        if caching_strategy == "direct":
            _PIPELINE.bind(hdf5_file=hdf5_file)
        else:
            _PIPELINE.bind(hdf5_file or "TEMP")
    print(f"World seed: {_PIPELINE.seed}")
    return _PIPELINE


def configure(**config):
    global _PIPELINE, _PIPELINE_CONFIG
    _PIPELINE = None
    _PIPELINE_CONFIG = config


def _coarse_window(world, ci0, ci1, cj0, cj1) -> np.ndarray:
    """All 6 normalized coarse channels for a window in ONE read/assembly
    (the per-channel helper re-read and re-normalized the full window for
    every channel — up to 11x the work per stats/hover request)."""
    coarse = world.coarse[:, ci0:ci1, cj0:cj1]
    data = np.asarray(coarse[:-1] / (coarse[-1:] + 1e-8))
    data[:2] = np.sign(data[:2]) * np.square(data[:2])
    return data



_VIRIDIS_STOPS = np.array([
    [0.267, 0.005, 0.329], [0.283, 0.141, 0.458], [0.254, 0.265, 0.530],
    [0.207, 0.372, 0.553], [0.164, 0.471, 0.558], [0.128, 0.567, 0.551],
    [0.135, 0.659, 0.518], [0.267, 0.749, 0.441], [0.478, 0.821, 0.318],
    [0.741, 0.873, 0.150], [0.993, 0.906, 0.144],
], dtype=np.float32)


def _viridis(norm: np.ndarray) -> np.ndarray:
    pos = np.linspace(0, 1, len(_VIRIDIS_STOPS))
    n = np.clip(norm, 0, 1)
    rgba = np.empty((*n.shape, 4), dtype=np.float32)
    for c in range(3):
        rgba[..., c] = np.interp(n, pos, _VIRIDIS_STOPS[:, c])
    rgba[..., 3] = 1.0
    return rgba


def _png_response(rgba: np.ndarray) -> Response:
    from PIL import Image

    arr = (np.clip(rgba, 0, 1) * 255).astype(np.uint8)
    img = Image.fromarray(arr, mode="RGBA" if arr.shape[-1] == 4 else "RGB")
    buf = io.BytesIO()
    img.save(buf, format="PNG")
    return Response(buf.getvalue(), mimetype="image/png")


@app.get("/")
def index(req):
    with open(os.path.join(_STATIC, "index.html"), "rb") as f:
        return Response(f.read(), mimetype="text/html")


@app.get("/api/status")
def status(req):
    world = _get_pipeline()
    return jsonify({"seed": str(world.seed), "channels": CHANNEL_NAMES,
                    "native_resolution": world.native_resolution,
                    # world pixels per coarse cell (32 latent px/cell):
                    # clients must use this instead of a hardcoded 256
                    "cell_px": 32 * world.latent_compression})


@app.post("/api/seed")
def set_seed(req):
    data = req.get_json() or {}
    if "seed" not in data:
        return jsonify({"error": "seed required"}, 400)
    world = _get_pipeline()
    try:
        # seeds are 64-bit and travel as STRINGS (a JS number loses
        # precision above 2^53, silently building a different world)
        seed = int(str(data["seed"]).strip())
    except (TypeError, ValueError):
        return jsonify({"error": "seed must be an integer"}, 400)
    world.change_seed(seed)
    return jsonify({"seed": str(world.seed)})


@app.post("/api/new_seed")
def new_seed(req):
    world = _get_pipeline()
    world.change_seed()
    return jsonify({"seed": str(world.seed)})


def _bounds(req):
    return (req.args.get("ci0", -50, int), req.args.get("ci1", 50, int),
            req.args.get("cj0", -50, int), req.args.get("cj1", 50, int))


@app.get("/api/coarse.png")
def coarse_png(req):
    try:
        world = _get_pipeline()
        channel = req.args.get("channel", 0, int)
        ci0, ci1, cj0, cj1 = _bounds(req)
        window = _coarse_window(world, ci0, ci1, cj0, cj1)
        data = window[channel]
        display = np.log1p(np.maximum(data, 0)) if channel == 4 else data
        vmin, vmax = float(np.nanmin(display)), float(np.nanmax(display))
        if vmax == vmin:
            vmax = vmin + 1
        rgba = _viridis((display - vmin) / (vmax - vmin))

        filterable = [0, 2, 3, 4, 5]
        filter_active = any(
            req.args.get(f"ch{ch}_{side}", type=float) is not None
            for ch in filterable for side in ("min", "max"))
        if filter_active:
            mask = np.ones(data.shape, dtype=bool)
            for ch in filterable:
                lo = req.args.get(f"ch{ch}_min", type=float)
                hi = req.args.get(f"ch{ch}_max", type=float)
                if lo is not None or hi is not None:
                    ch_data = window[ch]
                    if lo is not None:
                        mask &= ch_data >= lo
                    if hi is not None:
                        mask &= ch_data <= hi
            rgba[~mask, :3] *= 0.3

        resp = _png_response(rgba)
        resp.headers["X-Vmin"] = str(round(vmin, 3))
        resp.headers["X-Vmax"] = str(round(vmax, 3))
        resp.headers["Access-Control-Expose-Headers"] = "X-Vmin, X-Vmax"
        return resp
    except Exception as e:  # noqa: BLE001
        import traceback
        traceback.print_exc()
        return jsonify({"error": str(e)}, 400)


@app.get("/api/coarse_data.json")
def coarse_data(req):
    try:
        world = _get_pipeline()
        ci0, ci1, cj0, cj1 = _bounds(req)
        window = _coarse_window(world, ci0, ci1, cj0, cj1)
        channels = {
            name: np.round(window[i], 2).tolist()
            for i, name in enumerate(CHANNEL_NAMES)
        }
        return jsonify({"ci0": ci0, "ci1": ci1, "cj0": cj0, "cj1": cj1,
                        "channels": channels})
    except Exception as e:  # noqa: BLE001
        return jsonify({"error": str(e)}, 400)


@app.get("/api/coarse_stats")
def coarse_stats(req):
    try:
        world = _get_pipeline()
        ci0, ci1, cj0, cj1 = _bounds(req)
        stats = {}
        window = _coarse_window(world, ci0, ci1, cj0, cj1)
        for ch in range(len(CHANNEL_NAMES)):
            data = window[ch]
            stats[ch] = {"name": CHANNEL_NAMES[ch],
                         "min": round(float(np.nanmin(data)), 3),
                         "max": round(float(np.nanmax(data)), 3)}
        return jsonify(stats)
    except Exception as e:  # noqa: BLE001
        return jsonify({"error": str(e)}, 400)


def _detail_region(req, world):
    ci = req.args.get("ci", 0, int)
    cj = req.args.get("cj", 0, int)
    detail_size = req.args.get("detail_size", 1024, int)
    pan_i = req.args.get("pan_i", 0, int)
    pan_j = req.args.get("pan_j", 0, int)
    cell_px = 32 * world.latent_compression
    center_i = ci * cell_px + pan_i
    center_j = cj * cell_px + pan_j
    half = detail_size // 2
    return world.get(center_i - half, center_j - half,
                     center_i + half, center_j + half)


@app.get("/api/detail.png")
def detail_png(req):
    try:
        world = _get_pipeline()
        mode = req.args.get("mode", "relief")
        region = _detail_region(req, world)
        elev = np.asarray(region["elev"])
        if mode == "elevation":
            vmin, vmax = float(np.nanmin(elev)), float(np.nanmax(elev))
            if vmax == vmin:
                vmax = vmin + 1
            rgba = _viridis((elev - vmin) / (vmax - vmin))
        elif mode == "temperature" and region.get("climate") is not None:
            temp = np.asarray(region["climate"][0])
            vmin, vmax = float(np.nanmin(temp)), float(np.nanmax(temp))
            if vmax == vmin:
                vmax = vmin + 1
            rgba = _viridis((temp - vmin) / (vmax - vmin))
        else:
            relief_rgb = get_relief_map(elev, None, None, None,
                                        resolution=world.native_resolution)
            rgba = np.concatenate(
                [np.clip(relief_rgb, 0, 1),
                 np.ones((*relief_rgb.shape[:2], 1), np.float32)], axis=-1)
        return _png_response(rgba)
    except Exception as e:  # noqa: BLE001
        import traceback
        traceback.print_exc()
        return jsonify({"error": str(e)}, 400)


@app.get("/api/detail_raw")
def detail_raw(req):
    try:
        world = _get_pipeline()
        region = _detail_region(req, world)
        elev_np = np.asarray(region["elev"], dtype=np.float32)
        elev_i16 = np.clip(np.floor(elev_np), -32768, 32767).astype("<i2")
        h, w = elev_i16.shape
        payload = elev_i16.tobytes()
        has_temp = region.get("climate") is not None
        if has_temp:
            payload += np.asarray(region["climate"][0], dtype="<f4").tobytes()
        return Response(payload, mimetype="application/octet-stream", headers={
            "X-Height": str(h), "X-Width": str(w),
            "X-Has-Temp": "1" if has_temp else "0",
            "Access-Control-Expose-Headers": "X-Height, X-Width, X-Has-Temp"})
    except Exception as e:  # noqa: BLE001
        import traceback
        traceback.print_exc()
        return jsonify({"error": str(e)}, 400)


@click.command()
@click.argument("model_path")
@click.option("--caching-strategy", type=click.Choice(["indirect", "direct"]), default="direct")
@click.option("--hdf5-file", default=None)
@click.option("--cache-size", default="100M")
@click.option("--seed", type=int, default=None)
@click.option("--batch-size", default="1,2,4,8,16")
@click.option("--log-mode", type=click.Choice(["info", "verbose"]), default="verbose")
@click.option("--dtype", type=click.Choice(["fp32", "bf16", "fp16"]), default="fp32")
@click.option("--host", default="0.0.0.0")
@click.option("--port", type=int, default=int(os.getenv("PORT", "8080")))
@click.option("--threaded/--no-threaded", default=False,
              help="Accept concurrent clients (generation stays serialized)")
@click.option("--device", default="cuda", show_default=True,
              help="--device cpu runs on the CPU")
@click.option("--kwarg", "extra_kwargs", multiple=True)
def main(model_path, caching_strategy, hdf5_file, cache_size, seed, batch_size,
         log_mode, dtype, host, port, threaded, device, extra_kwargs):
    """Terrain Explorer web app."""
    click_check_device(device)
    if caching_strategy == "indirect" and hdf5_file is None:
        hdf5_file = "TEMP"
    batch_sizes = parse_batch_sizes(batch_size)
    configure(
        model_path=model_path, hdf5_file=hdf5_file,
        caching_strategy=caching_strategy,
        cache_limit=parse_cache_size(cache_size), seed=seed,
        latents_batch_size=batch_sizes, log_mode=log_mode,
        dtype=None if dtype == "fp32" else dtype, device=device,
        kwargs=parse_kwargs(extra_kwargs))
    _get_pipeline()
    app.run(host=host, port=port, threaded=threaded)


if __name__ == "__main__":
    main()
