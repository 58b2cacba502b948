"""Terrain REST API of the PyTorch port - the same routes and wire format as
``terrain_diffusion_tpu.serving.api``:

- ``GET /health``                      -> {"status": "ok"}
- ``GET /seed`` / ``POST /seed``       -> current / changed world seed
- ``GET /terrain?i1&j1&i2&j2&scale[&seed]`` -> binary int16-LE elevation
  (H*W*2 bytes, floored meters, clamped) followed by float32-LE interleaved
  (H, W, 4) climate [temp, t_season, precip, p_cv]; X-Height/X-Width headers.

``scale > 1`` fetches the padded native region and upsamples bilinearly.
``--threaded`` accepts concurrent clients and coalesces their tile requests
into shared stage batches (``serving/coalesce.py``).  ``--caching-strategy
indirect [--hdf5-file F]`` serves from (and persists to) an HDF5 world file,
a temporary one without ``--hdf5-file``.

Run:
    python -m terrain_diffusion_tpu_torch.serving.api <model_path> --device cuda
"""
from __future__ import annotations

import argparse
import os
from typing import Optional

import numpy as np
import torch

from terrain_diffusion_tpu_torch.common.cli_helpers import (check_device, parse_batch_sizes,
                                                           parse_cache_size, parse_kwargs)
from terrain_diffusion_tpu_torch.serving.httpd import App, Response, jsonify

app = App("terrain-api")
_STATE = {"pipeline": None, "config": {}}


def configure(**config):
    """Set the pipeline config (CLI and tests); ``pipeline=`` injects a
    ready WorldPipeline (bound on first use if it is not bound yet);
    ``coalesce=True`` wraps it in a CoalescedPipeline for threaded serving."""
    _STATE["pipeline"] = None
    _STATE["config"] = config


def _get_pipeline():
    if _STATE["pipeline"] is not None:
        return _STATE["pipeline"]
    cfg = _STATE["config"]
    pipe = cfg.get("pipeline")
    if pipe is None:
        from terrain_diffusion_tpu_torch.pipeline.world import WorldPipeline

        pipe = WorldPipeline.from_pretrained(
            cfg["model_path"], seed=cfg.get("seed"),
            latents_batch_size=cfg.get("latents_batch_size", 4),
            log_mode=cfg.get("log_mode", "verbose"), dtype=cfg.get("dtype"),
            caching_strategy=cfg.get("caching_strategy", "direct"),
            cache_limit=cfg.get("cache_limit"), device=cfg.get("device", "cuda"),
            **cfg.get("kwargs", {}))
    if pipe.tile_store is None:
        if pipe.caching_strategy == "direct":
            pipe.bind(hdf5_file=cfg.get("hdf5_file"))
        else:
            pipe.bind(cfg.get("hdf5_file") or "TEMP")
    if cfg.get("coalesce"):
        from terrain_diffusion_tpu_torch.serving.coalesce import CoalescedPipeline

        pipe = CoalescedPipeline(pipe)
    print(f"World seed: {pipe.seed}")
    _STATE["pipeline"] = pipe
    return pipe


def _parse_quad(req):
    vals = []
    for name in ("i1", "j1", "i2", "j2"):
        v = req.args.get(name, type=int)
        if v is None:
            raise ValueError(f"Missing required query param '{name}'")
        vals.append(v)
    i1, j1, i2, j2 = vals
    if i2 <= i1 or j2 <= j1:
        raise ValueError("Expected i2>i1 and j2>j1")
    return i1, j1, i2, j2


def _elev_to_int16(elev: np.ndarray) -> np.ndarray:
    if elev.dtype == np.int16:  # packed on the device (pack_wire)
        return elev.astype("<i2", copy=False)
    trans = np.floor(elev.astype(np.float32, copy=False))
    return np.clip(trans, -32768, 32767).astype("<i2", copy=False)


def _binary_response(elev: np.ndarray, climate: Optional[np.ndarray]) -> Response:
    elev_i16 = _elev_to_int16(elev)
    h, w = elev_i16.shape
    payload = elev_i16.tobytes()
    if climate is not None and climate.shape[0] >= 4:
        payload += np.transpose(climate[:4].astype("<f4", copy=False), (1, 2, 0)).tobytes()
    return Response(payload, mimetype="application/octet-stream",
                    headers={"X-Height": str(h), "X-Width": str(w)})


def _bilinear_up(arr: np.ndarray, scale: int) -> np.ndarray:
    from terrain_diffusion_tpu_torch.ops.image import resize_bilinear

    h, w = arr.shape[-2:]
    out = resize_bilinear(torch.from_numpy(np.array(arr, np.float32)), (h * scale, w * scale))
    return out.numpy()


def get_terrain(world, i1: int, j1: int, i2: int, j2: int, scale: int,
                seed: int | None = None) -> dict:
    """Terrain at arbitrary scale (target coords); scale>1 supersamples.

    On a coalesced pipeline `seed` rides inside the terrain job, so the
    request is atomic under concurrent seed changes; a plain pipeline
    changes its seed first (single-threaded serving, no race)."""
    kw = {}
    if seed is not None:
        if hasattr(world, "_coalescer"):
            kw["seed"] = seed
        elif world.change_seed(seed):
            print(f"World seed changed to: {world.seed}")
    if scale == 1:
        out = world.get(i1, j1, i2, j2, with_climate=True, pack_wire=True, **kw)
        return {"elev": out["elev"], "climate": out.get("climate")}
    i1n, j1n = i1 // scale, j1 // scale
    i2n, j2n = -(-i2 // scale), -(-j2 // scale)
    out_native = world.get(i1n - 1, j1n - 1, i2n + 1, j2n + 1, with_climate=True, **kw)
    out_h, out_w = i2 - i1, j2 - j1
    ci, cj = scale + i1 - i1n * scale, scale + j1 - j1n * scale
    elev = _bilinear_up(out_native["elev"], scale)[ci:ci + out_h, cj:cj + out_w]
    climate = None
    if out_native.get("climate") is not None:
        climate = _bilinear_up(out_native["climate"], scale)[:, ci:ci + out_h, cj:cj + out_w]
    return {"elev": elev, "climate": climate}


@app.get("/health")
def health(req):
    return jsonify({"status": "ok"})


@app.get("/seed")
def get_seed(req):
    return jsonify({"seed": _get_pipeline().seed})


@app.post("/seed")
def post_seed(req):
    world = _get_pipeline()
    body = req.get_json(silent=True) or {}
    world.change_seed(body.get("seed"))
    return jsonify({"seed": world.seed})


@app.get("/terrain")
def terrain(req):
    try:
        i1, j1, i2, j2 = _parse_quad(req)
        scale = req.args.get("scale", default=1, type=int)
        if scale < 1:
            raise ValueError("scale must be >= 1")
        out = get_terrain(_get_pipeline(), i1, j1, i2, j2, scale,
                          seed=req.args.get("seed", type=int))
        return _binary_response(out["elev"], out.get("climate"))
    except (ValueError, NotImplementedError) as e:  # client errors
        return jsonify({"error": str(e)}, 400)


def main(argv=None):
    ap = argparse.ArgumentParser(description="Terrain API server (PyTorch port).")
    ap.add_argument("model_path")
    ap.add_argument("--device", default="cuda", help="--device cpu runs on the CPU")
    ap.add_argument("--caching-strategy", choices=["indirect", "direct"], default="direct",
                    help="'indirect' keeps the world's windows in an HDF5 file (needs h5py)")
    ap.add_argument("--hdf5-file", default=None,
                    help="the world file of indirect caching (default: a temporary file)")
    ap.add_argument("--cache-size", default="100M")
    ap.add_argument("--seed", type=int, default=None)
    ap.add_argument("--batch-size", default="1,4")
    ap.add_argument("--log-mode", choices=["info", "verbose"], default="verbose")
    ap.add_argument("--dtype", choices=["fp32", "bf16", "fp16"], default="fp32",
                    help="the stage models' compute type")
    ap.add_argument("--host", default="0.0.0.0")
    ap.add_argument("--port", type=int, default=int(os.getenv("PORT", "8000")))
    ap.add_argument("--threaded", action=argparse.BooleanOptionalAction, default=False,
                    help="accept concurrent clients; their tile requests coalesce "
                         "into shared stage batches")
    ap.add_argument("--warmup", action=argparse.BooleanOptionalAction, default=False,
                    help="serve three warm-up tiles before accepting clients")
    ap.add_argument("--kwarg", dest="extra_kwargs", action="append", default=[],
                    help="additional key=value pipeline kwargs")
    args = ap.parse_args(argv)
    check_device(ap, args.device)
    hdf5_file = args.hdf5_file
    if args.caching_strategy == "indirect" and hdf5_file is None:
        hdf5_file = "TEMP"
    configure(model_path=args.model_path, device=args.device, hdf5_file=hdf5_file,
              caching_strategy=args.caching_strategy,
              cache_limit=parse_cache_size(args.cache_size), seed=args.seed,
              latents_batch_size=parse_batch_sizes(args.batch_size),
              log_mode=args.log_mode, dtype=None if args.dtype == "fp32" else args.dtype,
              kwargs=parse_kwargs(args.extra_kwargs),
              coalesce=args.threaded)
    pipe = _get_pipeline()
    if args.warmup:
        print("Warming up ...")
        print(f"Warmup done: {pipe.warmup()}")
    app.run(host=args.host, port=args.port, threaded=args.threaded,
            serialize=not args.threaded)


if __name__ == "__main__":
    main()
