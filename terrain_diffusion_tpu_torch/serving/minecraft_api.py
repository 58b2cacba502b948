"""Minecraft terrain API of the PyTorch port - the same routes, wire format
and post-processing as ``terrain_diffusion_tpu.serving.minecraft_api``:

- ``GET /health``                                  -> {"status": "ok"}
- ``GET /terrain?i1&j1&i2&j2[&scale][&noise][&seed][&format=json]`` (and the
  legacy ``/90 /45 /22 /11``, scales 1, 2, 4, 8) -> binary int16-LE
  elevation (floored meters) followed by int16-LE biome ids, with
  X-Height/X-Width headers; ``format=json`` returns the elevation as JSON.

Scales above 1 upsample the padded native region bilinearly and restore
detail with slope-modulated Perlin noise; biomes come from the rule-based
climate classifier (PET / aridity / growing season -> tree coverage x snow x
elevation masks -> Minecraft biome ids).  NumPy throughout: this is the
serving-side post-process, the model path stays on the pipeline's device.
``--threaded`` accepts concurrent clients and coalesces their chunk requests
into shared stage batches (``serving/coalesce.py``).

Run:
    python -m terrain_diffusion_tpu_torch.serving.minecraft_api <world_dir> \\
        --device cuda --threaded
"""
from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from terrain_diffusion_tpu_torch.common.cli_helpers import (check_device, parse_batch_sizes,
                                                           parse_cache_size, parse_kwargs)
from terrain_diffusion_tpu_torch.ops.image import resize_bilinear
from terrain_diffusion_tpu_torch.ops.perlin import perlin_fbm
from terrain_diffusion_tpu_torch.serving.httpd import App, Response, jsonify

app = App("minecraft-api")

_PIPELINE = None
_PIPELINE_CONFIG: dict = {}

BIOME_ID = {
    "plains": 1, "snowy_plains": 3, "desert": 5, "swamp": 6, "forest": 8,
    "taiga": 15, "snowy_taiga": 16, "savanna": 17, "windswept_hills": 19,
    "jungle": 23, "badlands": 26, "meadow": 29, "grove": 31,
    "snowy_slopes": 32, "frozen_peaks": 33, "stony_peaks": 35,
    "forest_sparse": 108, "taiga_sparse": 115, "snowy_taiga_sparse": 116,
}

# (seed, frequency, octaves, lacunarity, gain) noise configs
_TEMP_NOISE = (12345, 1 / 500.0, 3, 2.0, 0.5)
_TEMP_NOISE_FINE = (54321, 1 / 128.0, 2, 2.0, 0.5)
_PRECIP_NOISE = (12345, 1 / 500.0, 5, 2.0, 0.5)
_SNOW_NOISE = (12345, 1 / 500.0, 3, 2.0, 0.5)
_SNOW_NOISE_FINE = (54321, 1 / 128.0, 2, 2.0, 0.5)
_ELEV_NOISE_COARSE = (99999, 1 / 24.0, 3, 2.0, 0.5)
_ELEV_NOISE_FINE = (88888, 1 / 6.0, 2, 2.0, 0.6)


def _noise_grid(cfg, i0, j0, h, w):
    seed, freq, octaves, lac, gain = cfg
    yy, xx = np.meshgrid(np.arange(i0, i0 + h, dtype=np.float32),
                         np.arange(j0, j0 + w, dtype=np.float32), indexing="ij")
    return perlin_fbm(seed, freq, octaves, lac, gain,
                      xx.ravel(), yy.ravel()).reshape(h, w)


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
            cfg.get("model_path"), seed=cfg.get("seed"),
            latents_batch_size=cfg.get("latents_batch_size", 4),
            log_mode=cfg.get("log_mode", "verbose"), dtype=cfg.get("dtype"),
            caching_strategy=caching_strategy, cache_limit=cfg.get("cache_limit"),
            device=cfg.get("device", "cuda"), **cfg.get("kwargs", {}))
    if _PIPELINE.tile_store is None:
        hdf5_file = cfg.get("hdf5_file")
        if caching_strategy == "direct":
            _PIPELINE.bind(hdf5_file=hdf5_file)
        else:
            _PIPELINE.bind(hdf5_file or "TEMP")
    if cfg.get("coalesce"):
        from terrain_diffusion_tpu_torch.serving.coalesce import CoalescedPipeline

        _PIPELINE = CoalescedPipeline(_PIPELINE)
    print(f"World seed: {_PIPELINE.seed}")
    return _PIPELINE


def configure(**config):
    global _PIPELINE, _PIPELINE_CONFIG
    _PIPELINE = None
    _PIPELINE_CONFIG = config


def compute_climate_vars(temp, t_season, precip, p_cv) -> dict:
    """Derived ecological variables (reference `_compute_climate_vars`)."""
    t_std = t_season / 100.0
    t_eff = np.clip(temp + 0.5 * t_std, 0, None)
    pet = np.clip(250.0 + 25.0 * t_eff + 0.7 * t_eff**2, 250.0, None)
    aridity_index = precip / np.clip(pet, 1, None)
    seasonality_penalty = 1.0 - 0.35 * np.clip(p_cv / 100.0, None, 1.0)
    tree_moisture = aridity_index * seasonality_penalty
    amplitude = t_std * 1.414
    x = (5.0 - temp) / np.clip(amplitude, 0.1, None)
    growing_season = np.where(
        x <= -1.0, 365.0,
        np.where(x >= 1.0, 0.0,
                 365.0 * (0.5 - np.arcsin(np.clip(x, -1.0, 1.0)) / np.pi)))
    coldest_month = temp - 2.0 * t_std
    return {
        "pet": pet, "aridity_index": aridity_index,
        "tree_moisture": tree_moisture, "growing_season": growing_season,
        "frost_free": temp >= 10.0, "hard_frost": coldest_month < -10.0,
        "tropical": (temp >= 18.0) & (t_std < 5.0),
        "coldest_month": coldest_month,
    }


def _sobel_gradient(elev_padded):
    """Sobel gradient magnitude from a 1-px padded field."""
    p = elev_padded
    dx = ((p[:-2, 2:] + 2 * p[1:-1, 2:] + p[2:, 2:]) -
          (p[:-2, :-2] + 2 * p[1:-1, :-2] + p[2:, :-2])) / 8.0
    dy = ((p[2:, :-2] + 2 * p[2:, 1:-1] + p[2:, 2:]) -
          (p[:-2, :-2] + 2 * p[:-2, 1:-1] + p[:-2, 2:])) / 8.0
    return np.sqrt(dx**2 + dy**2)


def classify_biome(elev, climate, i0, j0, elev_padded, pixel_size_m=90.0) -> np.ndarray:
    """Rule-based biome classifier; returns (H, W) int16 biome ids
    (reference `_classify_biome`, `minecraft_api.py:357-686`)."""
    h, w = elev.shape
    if climate is None or climate.shape[0] < 4:
        return np.full((h, w), BIOME_ID["plains"], np.int16)

    alt_m = np.clip(elev, 0.0, None)
    temp = np.asarray(climate[0], np.float32)
    t_season = np.asarray(climate[1], np.float32)
    precip = np.clip(np.asarray(climate[2], np.float32), 0.0, None)
    p_cv = np.asarray(climate[3], np.float32)

    temp = temp + 0.4 * _noise_grid(_TEMP_NOISE, i0, j0, h, w) + \
        0.2 * _noise_grid(_TEMP_NOISE_FINE, i0, j0, h, w)
    precip = precip * (1.0 + 0.2 * _noise_grid(_PRECIP_NOISE, i0, j0, h, w))
    snow_noise = 3.0 * _noise_grid(_SNOW_NOISE, i0, j0, h, w) + \
        2.0 * _noise_grid(_SNOW_NOISE_FINE, i0, j0, h, w)

    cv = compute_climate_vars(temp, t_season, precip, p_cv)
    tree_moisture = cv["tree_moisture"]
    tropical = cv["tropical"]
    growing_season = cv["growing_season"]

    slope_ratio = _sobel_gradient(elev_padded) / pixel_size_m
    is_steep = slope_ratio > 0.78

    gs_factor = np.clip((growing_season - 60.0) / 90.0, 0.0, 1.0)
    eff_tree_moisture = tree_moisture * gs_factor
    moisture_factor = np.clip((tree_moisture - 0.35) / 0.45, 0.0, 1.0)
    bare_threshold = 0.7 + (1.19 - 0.7) * moisture_factor

    trees_none = eff_tree_moisture < 0.2
    too_arid = tree_moisture < 0.05
    too_cold = growing_season < 60.0
    barren = too_arid | too_cold
    trees_sparse = ~trees_none & (eff_tree_moisture < 0.5)
    trees_forest = ~trees_none & (eff_tree_moisture >= 0.5) & (eff_tree_moisture < 0.8)
    trees_dense = ~trees_none & (eff_tree_moisture >= 0.8) & (eff_tree_moisture < 1.3)
    trees_rainforest = ~trees_none & (eff_tree_moisture >= 1.3)

    slope_medium = (slope_ratio >= 0.62) & (slope_ratio < bare_threshold)
    slope_bare = slope_ratio >= bare_threshold
    had_trees = trees_forest | trees_dense | trees_rainforest
    trees_sparse = trees_sparse | (slope_medium & had_trees)
    trees_forest = trees_forest & ~slope_medium
    trees_dense = trees_dense & ~slope_medium
    trees_rainforest = trees_rainforest & ~slope_medium
    trees_none = trees_none | slope_bare
    trees_sparse = trees_sparse & ~slope_bare
    trees_forest = trees_forest & ~slope_bare
    trees_dense = trees_dense & ~slope_bare
    trees_rainforest = trees_rainforest & ~slope_bare

    snow_temp = temp + snow_noise
    would_have_snow = (snow_temp < 0.0) & (precip > 150.0)
    has_snow = would_have_snow & ~is_steep

    is_ocean = elev < 0.0
    mountains = alt_m > 2500.0
    lowland = alt_m < 200.0
    frozen = temp < -5.0
    cold = (temp >= -5.0) & (temp < 5.0)
    cool = (temp >= 5.0) & (temp < 12.0)
    temperate = (temp >= 12.0) & (temp < 20.0)
    warm = (temp >= 20.0) & (temp < 26.0)
    hot = temp >= 26.0

    out = np.full((h, w), BIOME_ID["plains"], np.int16)
    unassigned = np.ones((h, w), bool)

    # ocean
    ocean_frozen = is_ocean & frozen
    ocean_cold = is_ocean & cold & ~frozen
    ocean_warm = is_ocean & (warm | hot)
    ocean_normal = is_ocean & ~ocean_frozen & ~ocean_cold & ~ocean_warm
    out[ocean_frozen] = 48
    out[ocean_cold] = 46
    out[ocean_warm] = 41
    out[ocean_normal] = 44
    unassigned[is_ocean] = False

    # mountains
    mtn = mountains & unassigned
    out[mtn & slope_bare & has_snow] = BIOME_ID["frozen_peaks"]
    out[mtn & slope_bare & ~has_snow] = BIOME_ID["stony_peaks"]
    mtn_soil = mtn & ~slope_bare
    out[mtn_soil & has_snow & trees_none] = BIOME_ID["snowy_slopes"]
    out[mtn_soil & has_snow & (trees_sparse | trees_forest)] = BIOME_ID["snowy_taiga_sparse"]
    out[mtn_soil & has_snow & (trees_dense | trees_rainforest)] = BIOME_ID["snowy_taiga"]
    out[mtn_soil & ~has_snow & trees_none & barren] = BIOME_ID["windswept_hills"]
    mtn_cold_steppe = mtn_soil & ~has_snow & trees_none & ~barren & \
        ((tree_moisture < 0.35) | (precip < 350))
    out[mtn_cold_steppe] = BIOME_ID["grove"]
    out[mtn_soil & ~has_snow & trees_none & ~barren & ~mtn_cold_steppe] = BIOME_ID["plains"]
    out[mtn_soil & ~has_snow & (trees_sparse | trees_forest)] = BIOME_ID["taiga_sparse"]
    out[mtn_soil & ~has_snow & (trees_dense | trees_rainforest)] = BIOME_ID["taiga"]
    unassigned[mtn] = False

    land = unassigned
    snowy_barren = land & has_snow & trees_none
    out[snowy_barren] = BIOME_ID["snowy_plains"]
    land = land & ~snowy_barren
    sfs = land & has_snow & (trees_sparse | trees_forest)
    out[sfs] = BIOME_ID["snowy_taiga_sparse"]
    sfd = land & has_snow & (trees_dense | trees_rainforest)
    out[sfd] = BIOME_ID["snowy_taiga"]
    land = land & ~(sfs | sfd)

    dry_barren = land & ~has_snow & trees_none
    desert_mask = dry_barren & (warm | hot)
    out[desert_mask] = BIOME_ID["desert"]
    windswept_mask = dry_barren & (cold | cool | temperate) & ~lowland & barren
    out[windswept_mask] = BIOME_ID["grove"]
    cold_steppe = dry_barren & ((tree_moisture < 0.35) | (precip < 350)) & ~barren
    out[cold_steppe] = BIOME_ID["grove"]
    out[dry_barren & ~desert_mask & ~windswept_mask & ~cold_steppe] = BIOME_ID["plains"]
    land = land & ~dry_barren

    sparse_land = land & ~has_snow & (trees_sparse | trees_forest)
    out[sparse_land & hot] = BIOME_ID["jungle"]
    out[sparse_land & warm & trees_sparse & ~slope_medium] = BIOME_ID["savanna"]
    out[sparse_land & warm & trees_forest] = BIOME_ID["forest_sparse"]
    out[sparse_land & temperate] = BIOME_ID["forest_sparse"]
    out[sparse_land & (cool | cold)] = BIOME_ID["taiga_sparse"]
    land = land & ~sparse_land

    dense_land = land & ~has_snow & trees_dense
    jungle_dense = dense_land & hot
    out[jungle_dense] = BIOME_ID["jungle"]
    swamp_mask = dense_land & warm & lowland
    out[swamp_mask] = BIOME_ID["swamp"]
    taiga_dense = dense_land & (cool | cold) & ~jungle_dense & ~swamp_mask
    out[taiga_dense] = BIOME_ID["taiga"]
    out[dense_land & ~jungle_dense & ~swamp_mask & ~taiga_dense] = BIOME_ID["forest"]
    land = land & ~dense_land

    rain_land = land & ~has_snow & trees_rainforest
    jungle_rain = rain_land & (hot | (warm & tropical))
    out[jungle_rain] = BIOME_ID["jungle"]
    swamp_rain = rain_land & ~jungle_rain & lowland
    out[swamp_rain] = BIOME_ID["swamp"]
    taiga_rain = rain_land & (cool | cold) & ~jungle_rain & ~swamp_rain
    out[taiga_rain] = BIOME_ID["taiga"]
    out[rain_land & ~jungle_rain & ~swamp_rain & ~taiga_rain] = BIOME_ID["forest"]
    land = land & ~rain_land
    out[land] = BIOME_ID["plains"]

    lowland_bare = slope_bare & ~is_ocean & ~mountains
    out[lowland_bare & has_snow] = BIOME_ID["frozen_peaks"]
    out[lowland_bare & ~has_snow] = BIOME_ID["stony_peaks"]
    return out


def get_upsampled(world, i1, j1, i2, j2, scale, noise_scale=1.0,
                  pixel_size_m=90.0, get_kwargs=None) -> dict:
    """Bilinear upsample + slope-modulated Perlin detail restoration
    (reference `_get_upsampled`, `minecraft_api.py:264-354`)."""
    i1n, j1n = i1 // scale, j1 // scale
    i2n, j2n = -(-i2 // scale), -(-j2 // scale)
    out_native = world.get(i1n - 2, j1n - 2, i2n + 2, j2n + 2,
                           with_climate=True, **(get_kwargs or {}))
    elev_native = np.asarray(out_native["elev"])
    climate_native = out_native.get("climate")

    hN, wN = elev_native.shape
    elev_up = resize_bilinear(torch.from_numpy(np.array(elev_native, np.float32))[None],
                              (hN * scale, wN * scale)).numpy()[0]
    pad_up = 2 * scale
    ci = pad_up + (i1 - i1n * scale)
    cj = pad_up + (j1 - j1n * scale)
    h, w = i2 - i1, j2 - j1
    elev_smooth = elev_up[ci:ci + h, cj:cj + w]
    elev_padded = elev_up[ci - 1:ci + h + 1, cj - 1:cj + w + 1]

    climate = None
    if climate_native is not None:
        cl_up = resize_bilinear(torch.from_numpy(np.array(climate_native, np.float32)),
                                (hN * scale, wN * scale)).numpy()
        climate = cl_up[:, ci:ci + h, cj:cj + w]

    if noise_scale > 0 and h > 0 and w > 0:
        noise_coarse = _noise_grid(_ELEV_NOISE_COARSE, i1, j1, h, w)
        noise_fine = _noise_grid(_ELEV_NOISE_FINE, i1, j1, h, w)
        gradient = _sobel_gradient(elev_padded)
        slope_factor = np.clip(gradient / (40.0 * pixel_size_m / 90.0), 0, 1) ** 1.5
        amp_coarse = noise_scale * 100.0 * slope_factor * pixel_size_m / world.native_resolution
        amp_fine = noise_scale * 70.0 * slope_factor * pixel_size_m / world.native_resolution
        is_land = (elev_smooth >= 0.0).astype(np.float32)
        elev = elev_smooth + (noise_coarse * amp_coarse + noise_fine * amp_fine) * is_land
    else:
        elev = elev_smooth
    return {"elev": elev, "elev_smooth": elev_smooth, "climate": climate,
            "elev_padded": elev_padded}


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


def _tensor_to_json(elev) -> dict:
    """format=json body, exactly the reference's `_tensor_to_json`
    (`minecraft_api.py:74-80`): dtype + [h, w] shape + nested list."""
    arr = np.asarray(elev, np.float32)
    return {"dtype": "float32",
            "shape": [int(arr.shape[0]), int(arr.shape[1])],
            "elev": arr.tolist()}


def _binary_response(elev, biome=None) -> Response:
    elev_i16 = np.clip(np.floor(np.asarray(elev, np.float32)),
                       -32768, 32767).astype("<i2")
    h, w = elev_i16.shape
    payload = elev_i16.tobytes()
    if biome is not None:
        payload += np.asarray(biome, "<i2").tobytes()
    return Response(payload, mimetype="application/octet-stream",
                    headers={"X-Height": str(h), "X-Width": str(w)})


@app.get("/health")
def health(req):
    return jsonify({"status": "ok"})


def _seed_kwargs(req, world):
    """Per-request seed handling: on a coalesced pipeline the seed rides
    INSIDE the terrain job (atomic under concurrent seed changes); on a
    plain pipeline (single-threaded serving) change the seed up front."""
    seed = req.args.get("seed", type=int)
    if seed is None:
        return {}
    if hasattr(world, "_coalescer"):
        return {"seed": seed}
    if world.change_seed(seed):
        print(f"World seed changed to: {world.seed}")
    return {}


def _handle_1x(req):
    i1, j1, i2, j2 = _parse_quad(req)
    world = _get_pipeline()
    kw = _seed_kwargs(req, world)
    if hasattr(world, "get_boxes"):
        # ONE atomic job: both boxes under one seed in one batch, so the
        # Sobel slope never mixes elevations from two different worlds
        out_pad, out = world.get_boxes(
            [(i1 - 1, j1 - 1, i2 + 1, j2 + 1), (i1, j1, i2, j2)],
            with_climate=True, **kw)
    else:
        out_pad = world.get(i1 - 1, j1 - 1, i2 + 1, j2 + 1,
                            with_climate=False)
        out = world.get(i1, j1, i2, j2, with_climate=True)
    elev = np.asarray(out["elev"])
    biome = classify_biome(elev, out.get("climate"), i1, j1,
                           elev_padded=np.asarray(out_pad["elev"]),
                           pixel_size_m=world.native_resolution)
    if req.args.get("format") == "json":
        return jsonify(_tensor_to_json(elev))
    return _binary_response(elev, biome=biome)


def _handle_upsampled(req, scale: int):
    i1, j1, i2, j2 = _parse_quad(req)
    try:
        noise_scale = float(req.args.get("noise", "1.0"))
    except ValueError:
        noise_scale = 1.0
    world = _get_pipeline()
    kw = _seed_kwargs(req, world)
    pixel_size_m = world.native_resolution / scale
    out = get_upsampled(world, i1, j1, i2, j2, scale=scale,
                        noise_scale=noise_scale, pixel_size_m=pixel_size_m,
                        get_kwargs=kw)
    biome = classify_biome(out["elev_smooth"], out.get("climate"), i1, j1,
                           elev_padded=out["elev_padded"],
                           pixel_size_m=pixel_size_m)
    if req.args.get("format") == "json":
        return jsonify(_tensor_to_json(np.asarray(out["elev"])))
    return _binary_response(out["elev"], biome=biome)


@app.get("/terrain")
def terrain(req):
    try:
        scale = req.args.get("scale", default=1, type=int)
        if scale < 1:
            raise ValueError("scale must be >= 1")
        if scale == 1:
            return _handle_1x(req)
        return _handle_upsampled(req, scale=scale)
    except Exception as e:  # noqa: BLE001
        return jsonify({"error": str(e)}, 400)


def _legacy(scale):
    def handler(req):
        try:
            if scale == 1:
                return _handle_1x(req)
            return _handle_upsampled(req, scale=scale)
        except Exception as e:  # noqa: BLE001
            return jsonify({"error": str(e)}, 400)
    return handler


app.route("/90")(_legacy(1))
app.route("/45")(_legacy(2))
app.route("/22")(_legacy(4))
app.route("/11")(_legacy(8))


def main(argv=None):
    """Minecraft terrain API server."""
    ap = argparse.ArgumentParser(description="Minecraft terrain API server (PyTorch port).")
    ap.add_argument("model_path")
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
                    help="accept concurrent clients; chunk requests coalesce into "
                         "shared stage batches (one generation pass serves all "
                         "in-flight queries)")
    ap.add_argument("--warmup", action=argparse.BooleanOptionalAction, default=False,
                    help="serve three warm-up tiles before accepting clients")
    ap.add_argument("--kwarg", dest="extra_kwargs", action="append", default=[],
                    help="additional key=value pipeline kwargs")
    ap.add_argument("--device", default="cuda", help="--device cpu runs on the CPU")
    args = ap.parse_args(argv)
    check_device(ap, args.device)
    hdf5_file = args.hdf5_file
    if args.caching_strategy == "indirect" and hdf5_file is None:
        hdf5_file = "TEMP"
    configure(
        model_path=args.model_path, hdf5_file=hdf5_file,
        caching_strategy=args.caching_strategy,
        cache_limit=parse_cache_size(args.cache_size), seed=args.seed,
        latents_batch_size=parse_batch_sizes(args.batch_size), log_mode=args.log_mode,
        dtype=None if args.dtype == "fp32" else args.dtype,
        kwargs=parse_kwargs(args.extra_kwargs), coalesce=args.threaded,
        device=args.device)
    pipe = _get_pipeline()
    if args.warmup:
        print("Warming up ...")
        print(f"Warmup done: {pipe.warmup()}")
    app.run(host=args.host, port=args.port, threaded=args.threaded,
            serialize=not args.threaded)


if __name__ == "__main__":
    main()
