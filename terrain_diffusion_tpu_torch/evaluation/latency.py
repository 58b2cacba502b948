"""TTFT/TTST latency harness (counterpart of
``terrain_diffusion_tpu.evaluation.latency``): time to first tile and time
to the adjacent second tile over N runs at random far-apart locations,
with the cache emptied before each run and untimed warm-ups first; mean,
std, p5, p50 and p95, and the device's memory statistics.
``run_http_benchmark`` measures requests/s through the port's own serving
stack (``serving/api.py`` on the threaded ``httpd`` server, tile requests
coalesced).

Run (on the card unless ``--device cpu``):
    python -m terrain_diffusion_tpu_torch.evaluation.latency <world_dir> [--http]
"""
from __future__ import annotations

import json
import threading
import time
import urllib.request

import click
import numpy as np
import torch

from terrain_diffusion_tpu_torch.common.cli_helpers import click_check_device


def _stats(xs) -> dict:
    xs = np.asarray(xs)
    return {"mean": float(xs.mean()), "std": float(xs.std()),
            "p5": float(np.percentile(xs, 5)), "p50": float(np.percentile(xs, 50)),
            "p95": float(np.percentile(xs, 95))}


def run_latency(world, n_runs: int = 10, tile: int = 512, separation: int = 200 * 256,
                seed: int = 0, with_climate: bool = False,
                grid_aligned: bool = False) -> dict:
    """TTFT / TTST of ``tile``-sized queries; ``grid_aligned`` snaps every
    query to tile multiples (the reference's ``--grid-aligned`` ablation)."""
    rng = np.random.default_rng(seed)
    ttft, ttst = [], []
    # warm-up, untimed: the kernel build, the CUDA context and the
    # allocator, and for unaligned runs one off-grid alignment
    world.get(0, 0, tile, tile, with_climate=with_climate)
    if not grid_aligned:
        off = tile // 2 + 1
        world.get(off, off, off + tile, off + tile, with_climate=with_climate)
    for _ in range(n_runs):
        ci = int(rng.integers(-20, 20)) * separation
        cj = int(rng.integers(-20, 20)) * separation
        if not grid_aligned:
            ci += int(rng.integers(0, tile))
            cj += int(rng.integers(0, tile))
        world.empty_cache()
        t0 = time.perf_counter()
        world.get(ci, cj, ci + tile, cj + tile, with_climate=with_climate)
        ttft.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        world.get(ci + tile, cj, ci + 2 * tile, cj + tile, with_climate=with_climate)
        ttst.append(time.perf_counter() - t0)
    return {"ttft": _stats(ttft), "ttst": _stats(ttst), "tile": tile, "n_runs": n_runs,
            "grid_aligned": grid_aligned, "memory": device_memory_stats(world.device)}


def run_http_benchmark(pipeline, *, concurrency_levels=(1, 4, 8),
                       requests_per_client: int = 8, tile: int = 512,
                       coalesce: bool = True, host: str = "127.0.0.1") -> dict:
    """Requests/s through the serving stack at several client
    concurrencies: the ``serving/api.py`` routes (binary wire format) on the
    threaded ``httpd`` server, concurrent tile requests coalesced into
    shared stage batches when ``coalesce``.  Per level each client streams
    ``requests_per_client`` adjacent ``tile`` boxes at its own far-away
    location, after one untimed request there; every answer must carry the
    full payload.  Returns requests/s and the per-request p50 per level."""
    from terrain_diffusion_tpu_torch.serving import api as api_mod
    from terrain_diffusion_tpu_torch.serving.coalesce import CoalescedPipeline

    served = CoalescedPipeline(pipeline) if coalesce else pipeline
    api_mod.configure(pipeline=served)
    httpd = api_mod.app.make_server(host, 0, quiet=True, threaded=True,
                                    serialize=not coalesce)
    port = httpd.server_address[1]
    server_thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    server_thread.start()

    def fetch(i1, j1):
        url = f"http://{host}:{port}/terrain?i1={i1}&j1={j1}&i2={i1 + tile}&j2={j1 + tile}"
        with urllib.request.urlopen(url, timeout=600) as r:
            data = r.read()
            h, w = int(r.headers["X-Height"]), int(r.headers["X-Width"])
        expect = h * w * 2 + h * w * 16  # int16 elevation + 4-channel float32 climate
        if len(data) != expect or h != tile or w != tile:
            raise AssertionError(f"bad payload: {len(data)} bytes ({expect} expected), {h}x{w}")
        return len(data)

    results: dict = {"tile": tile, "requests_per_client": requests_per_client,
                     "coalesce": coalesce, "levels": {}}
    try:
        fetch(0, 0)  # global warm-up
        sep = 500 * tile
        for level_idx, c in enumerate(concurrency_levels):
            bases = [((level_idx * 64 + k + 7) * sep, (k + 3) * sep) for k in range(c)]
            for bi, bj in bases:  # per-region warm-up, untimed
                fetch(bi, bj)
            lat: list = []
            errors: list = []

            def client(bi, bj):
                try:
                    for r in range(1, requests_per_client + 1):
                        t0 = time.perf_counter()
                        fetch(bi + r * tile, bj)
                        lat.append(time.perf_counter() - t0)
                except Exception as e:  # noqa: BLE001 - raised after the join
                    errors.append(e)

            threads = [threading.Thread(target=client, args=b) for b in bases]
            t0 = time.perf_counter()
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            wall = time.perf_counter() - t0
            if errors:
                raise errors[0]
            n = c * requests_per_client
            results["levels"][str(c)] = {
                "clients": c, "requests": n, "wall_s": round(wall, 3),
                "requests_per_sec": round(n / wall, 3),
                "latency_p50_s": round(float(np.percentile(lat, 50)), 4)}
    finally:
        httpd.shutdown()
        httpd.server_close()
        server_thread.join(timeout=10)
        if coalesce:  # stop the coalescer's worker; the caller keeps the world
            served._coalescer.close()
    return results


def device_memory_stats(device="cuda") -> dict:
    """Current and peak device memory of ``device``, under the JAX
    package's keys: ``bytes_in_use`` and ``peak_bytes_in_use`` from the
    caching allocator, ``bytes_limit`` the card's total memory.  torch keeps
    no largest-allocation statistic, so ``largest_alloc_size`` is absent;
    on the CPU no statistic is available."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return {"available": False, "platform": dev.type}
    raw = torch.cuda.memory_stats(dev)
    _free, total = torch.cuda.mem_get_info(dev)
    return {"available": True, "platform": "gpu",
            "bytes_in_use": int(raw.get("allocated_bytes.all.current", 0)),
            "peak_bytes_in_use": int(raw.get("allocated_bytes.all.peak", 0)),
            "bytes_limit": int(total)}


@click.command()
@click.argument("model_path")
@click.option("--runs", type=int, default=10)
@click.option("--tile", type=int, default=512)
@click.option("--batch-size", default="1,2,4,8,16")
@click.option("--seed", type=int, default=0)
@click.option("--dtype", type=click.Choice(["fp32", "bf16", "fp16"]), default="bf16")
@click.option("--with-climate/--no-climate", default=False)
@click.option("--onestep-latent", is_flag=True, default=False)
@click.option("--t", "t_steps", type=int, default=2)
@click.option("--decoder-tile-size", type=int, default=512,
              help="decoder window size in px (reference decoder_tile_size)")
@click.option("--decoder-tile-stride", type=int, default=384,
              help="decoder window stride in px (< size means overlap blending)")
@click.option("--max-batch-size", type=int, default=None,
              help="power-of-2 cap: batch buckets [1, 2, ..., N] (overrides --batch-size)")
@click.option("--http", "http_mode", is_flag=True, default=False,
              help="Also measure requests/s through the HTTP serving stack at 1/4/8 "
                   "concurrent clients (threaded WSGI + coalescer).")
@click.option("--http-requests", type=int, default=8,
              help="Requests per client per concurrency level (--http).")
@click.option("--grid-aligned", is_flag=True, default=False,
              help="snap query boxes to tile multiples (reference ablation)")
@click.option("--device", default="cuda", help="--device cpu runs on the CPU")
def main(model_path, runs, tile, batch_size, seed, dtype, with_climate, onestep_latent,
         t_steps, decoder_tile_size, decoder_tile_stride, max_batch_size, http_mode,
         http_requests, grid_aligned, device):
    """Measure TTFT/TTST tile latency; prints and returns the result."""
    from terrain_diffusion_tpu_torch.pipeline.world import WorldPipeline

    click_check_device(device)
    if max_batch_size is not None:
        if max_batch_size & (max_batch_size - 1):
            raise click.BadParameter("must be a power of 2", param_hint="--max-batch-size")
        batch_sizes = [1 << i for i in range(max_batch_size.bit_length())]
    else:
        batch_sizes = ([int(x) for x in batch_size.split(",")] if "," in batch_size
                       else int(batch_size))
    world = WorldPipeline.from_pretrained(
        model_path, seed=seed, latents_batch_size=batch_sizes,
        dtype=None if dtype == "fp32" else dtype, T=t_steps, onestep_latent=onestep_latent,
        decoder_tile_size=decoder_tile_size, decoder_tile_stride=decoder_tile_stride,
        device=device)
    world.bind()
    out = run_latency(world, n_runs=runs, tile=tile, seed=seed, with_climate=with_climate,
                      grid_aligned=grid_aligned)
    if http_mode:
        out["http"] = run_http_benchmark(world, tile=tile, requests_per_client=http_requests)
    print(json.dumps(out, indent=2))
    return out


if __name__ == "__main__":
    main()
