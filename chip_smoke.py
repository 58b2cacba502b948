#!/usr/bin/env python3
"""Smoke test of the PyTorch port (terrain_diffusion_tpu_torch) on one CUDA card.

Run from the root of a checkout:  python3 chip_smoke.py

Phases, each of which exits non-zero on failure:
1. build the hand-written CUDA kernels from csrc/ (nvcc, sm_90a);
2. kernel phase: each kernel against its plain PyTorch version at the
   decoder's main-path shapes, batch 1 and 2 (and 16, the largest bucket),
   TF32 off on both sides, bar max|diff| / max|ref| < 1e-4 (float32,
   another summation order), with CUDA-event times of both;
3. model phase: the production-width decoder U-Net on the card (kernels)
   against the same module on the CPU (plain versions) on a 128x128 input;
4. serving phase: the three production-width models (random weights from a
   seeded generator) behind the port's HTTP API on a localhost port:
   /health and three /terrain requests (a 256x256 tile, the same tile again
   - byte-identical - and an overlapping crop), with launch counts proving
   the decoder ran through both kernels (26 fused blocks + 2 convs per
   decoder forward).

The last lines are a JSON kernel report, the card's name and power limit,
and {"ok": true, "device": {...}}.
"""
import configparser
import copy
import json
import os
import subprocess
import sys
import threading
import time
import urllib.request

ROOT = os.path.dirname(os.path.abspath(__file__))
KERNEL_TOL = 1e-4
SEED = 20261016


def fail(msg: str):
    print(f"chip_smoke FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str):
    if not cond:
        fail(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def model_config(rel_path: str) -> dict:
    """The [model] section of a training config, JSON-decoded."""
    cp = configparser.ConfigParser(interpolation=None)
    cp.optionxform = str
    with open(os.path.join(ROOT, rel_path)) as f:
        cp.read_file(f)
    return {k: json.loads(v) for k, v in cp["model"].items() if not k.startswith("@")}


def time_ms(fn, iters: int = 5) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def kernel_phase(torch, fb, dev):
    g = torch.Generator().manual_seed(SEED)

    def rand(*shape, scale=1.0):
        return (torch.randn(shape, generator=g) * scale).to(dev)

    def block_case(n, hs, cx, cout, mode, x2=False, proj=False, up=1):
        cg = 2 * cx if x2 else cx
        c_main = cout if (mode == "enc" and proj) else cg
        args = (rand(n, hs, hs, cx),
                rand(3, 3, c_main, cout, scale=(9 * c_main) ** -0.5),
                rand(3, 3, cout, cout, scale=(9 * cout) ** -0.5),
                rand(n, cout, scale=0.3) + 1.0,
                rand(cg, cout, scale=cg ** -0.5) if proj else None,
                rand(n, hs, hs, cx) if x2 else None)
        kw = dict(mode=mode, pixel_norm=(mode == "enc"), res_balance=0.3,
                  clip_act=256.0, concat_scales=(0.7, 0.3) if x2 else None,
                  pre_upsample=up)
        return (lambda: fb.fused_block(*args, **kw),
                lambda: fb.fused_block_reference(*args, **kw))

    def conv_case(n, cin, cout):
        args = (rand(n, 512, 512, cin), rand(3, 3, cin, cout, scale=(9 * cin) ** -0.5))
        return lambda: fb.conv3x3(*args), lambda: fb.conv3x3_reference(*args)

    cases = []
    for n in (1, 2):
        cases += [
            ("fused_block", f"enc 512x512 64->64 b{n}", block_case(n, 512, 64, 64, "enc")),
            ("fused_block", f"enc 256x256 proj 64->128 b{n}",
             block_case(n, 256, 64, 128, "enc", proj=True)),
            ("fused_block", f"dec 128x128 pre-up 256 b{n}",
             block_case(n, 64, 256, 256, "dec", up=2)),
            ("fused_block", f"dec 512x512 x2-concat 64+64->64 b{n}",
             block_case(n, 512, 64, 64, "dec", x2=True, proj=True)),
            ("fused_block", f"dec 512x512 proj 192->64 b{n}",
             block_case(n, 512, 192, 64, "dec", proj=True)),
            ("conv3x3", f"in conv 512x512 6->64 b{n}", conv_case(n, 6, 64)),
            ("conv3x3", f"out conv 512x512 64->1 b{n}", conv_case(n, 64, 1)),
        ]
    cases += [  # the largest decoder bucket
        ("fused_block", "enc 512x512 64->64 b16", block_case(16, 512, 64, 64, "enc")),
        ("conv3x3", "out conv 512x512 64->1 b16", conv_case(16, 64, 1)),
    ]
    rows = []
    for kernel, name, (run, ref) in cases:
        got = run()
        torch.cuda.synchronize()
        want = ref()
        err_abs = float((got - want).abs().max())
        rel = err_abs / float(want.abs().max())
        ms, plain_ms = time_ms(run), time_ms(ref)
        print(f"[kernel] {kernel:11s} {name:34s} rel_err={rel:.3e} "
              f"max_abs_err={err_abs:.3e} kernel={ms:.3f} ms plain={plain_ms:.3f} ms",
              flush=True)
        check(bool(torch.isfinite(got).all()), f"{name}: non-finite output")
        check(rel < KERNEL_TOL, f"{name}: rel err {rel:.3e} >= {KERNEL_TOL}")
        rows.append(dict(kernel=kernel, case=name, max_abs_err=err_abs, rel_err=rel,
                         ms=ms, plain_ms=plain_ms))
        del got, want
    return rows


def build_models(torch, dev):
    from terrain_diffusion_tpu_torch.nn.edm_unet import EDMUnet2D, EDMUnetConfig

    g = torch.Generator().manual_seed(SEED + 1)
    models = []
    for rel in ("configs/diffusion_coarse/diffusion_coarse.cfg",
                "configs/diffusion_base/diffusion_192-3.cfg",
                "configs/diffusion_decoder/diffusion_decoder_64-3.cfg"):
        m = EDMUnet2D(EDMUnetConfig.from_dict(model_config(rel)), device=dev, generator=g)
        with torch.no_grad():  # init leaves the gains at 0: a constant network
            for name, p in m.named_parameters():
                if name.endswith("emb_gain"):
                    p.copy_(torch.randn((), generator=g) * 0.5)
                elif name == "out_gain":
                    p.fill_(1.0)
        models.append(m.eval())
        print(f"[model] {rel}: {m.count_parameters() / 1e6:.2f} M parameters", flush=True)
    return models


def model_phase(torch, decoder, dev):
    """Decoder U-Net on the card (kernels) vs the same module on the CPU
    (plain versions), 128x128 input: the 128-px level takes the kernels."""
    g = torch.Generator().manual_seed(SEED + 2)
    x = torch.randn((1, 128, 128, 5), generator=g)
    nl = torch.full((1,), 1.2)
    with torch.no_grad():
        got = decoder(x.to(dev), nl.to(dev), []).cpu()
        want = copy.deepcopy(decoder).cpu()(x, nl, [])
    rel = float((got - want).abs().max() / want.abs().max())
    print(f"[model] decoder 128x128 card vs CPU: rel_err={rel:.3e}", flush=True)
    check(bool(torch.isfinite(got).all()) and rel < KERNEL_TOL,
          f"decoder forward on the card disagrees with the CPU: {rel:.3e}")


def http_get(port: int, path: str):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=900) as r:
        return r.status, dict(r.headers), r.read()


def serving_phase(torch, np, fb, models, dev):
    from terrain_diffusion_tpu_torch.pipeline.world import WorldPipeline
    from terrain_diffusion_tpu_torch.serving import api

    pipe = WorldPipeline(seed=SEED, noise_mode="portable", device=dev).set_models(*models)
    t0 = time.perf_counter()
    pipe.bind()  # set-up (synthetic-map quantile tables), timed apart from requests
    print(f"[serve] bind {(time.perf_counter() - t0) * 1000:.1f} ms", flush=True)
    api.configure(pipeline=pipe)
    httpd = api.app.make_server("127.0.0.1", 0, quiet=True)
    port = httpd.server_address[1]
    server = threading.Thread(target=httpd.serve_forever, daemon=True)
    server.start()
    reqs = []
    try:
        status, _, body = http_get(port, "/health")
        check(status == 200 and json.loads(body) == {"status": "ok"}, "/health")
        torch.cuda.reset_peak_memory_stats()
        fb.reset_launch_counts()
        for path in ("/terrain?i1=0&j1=0&i2=256&j2=256&scale=1",
                     "/terrain?i1=0&j1=0&i2=256&j2=256&scale=1",
                     "/terrain?i1=128&j1=192&i2=384&j2=448&scale=1"):
            dec_before = pipe.stage_timings.get("decoder", [0, 0.0])[0]
            t0 = time.perf_counter()
            status, headers, body = http_get(port, path)
            wall = time.perf_counter() - t0
            dec_calls = pipe.stage_timings.get("decoder", [0, 0.0])[0] - dec_before
            reqs.append((path, wall, dec_calls, body))
            h, w = int(headers["X-Height"]), int(headers["X-Width"])
            check(status == 200 and (h, w) == (256, 256), f"{path}: {status} {h}x{w}")
            check(len(body) == h * w * 2 + h * w * 4 * 4, f"{path}: payload {len(body)}")
            elev = np.frombuffer(body[:h * w * 2], dtype="<i2")
            climate = np.frombuffer(body[h * w * 2:], dtype="<f4")
            check(bool(np.isfinite(climate).all()), f"{path}: non-finite climate")
            check(elev.min() > -32768 and elev.max() < 32767 and elev.std() > 0,
                  f"{path}: elevation saturated or constant")
            print(f"[serve] GET {path}: {wall * 1000:.1f} ms, decoder batches "
                  f"{dec_calls}, elev [{elev.min()}, {elev.max()}] m", flush=True)
    finally:
        httpd.shutdown()
        httpd.server_close()
        server.join(timeout=60)
    check(reqs[0][3] == reqs[1][3], "repeated /terrain request is not byte-identical")
    n_dec = sum(r[2] for r in reqs)
    launches = {"fused_block": fb.fused_block.launches, "conv3x3": fb.conv3x3.launches}
    print(f"[serve] decoder forwards {n_dec}, launches {launches}", flush=True)
    check(n_dec > 0, "no decoder forward ran")
    check(launches == {"fused_block": 26 * n_dec, "conv3x3": 2 * n_dec},
          f"launch counts {launches} != 26 / 2 per decoder forward ({n_dec})")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    for stage, v in pipe.timing_summary().items():
        print(f"[serve] stage {stage:16s} calls={v['calls']:4d} total={v['total_s'] * 1000:.1f} ms "
              f"mean={v['mean_ms']:.2f} ms", flush=True)
    print(f"[serve] peak device memory {peak:.2f} GiB", flush=True)
    return launches


def main():
    try:
        import torch
    except ImportError:
        fail("PyTorch is not installed")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke test needs a CUDA card")
    sys.path.insert(0, ROOT)
    try:
        import numpy as np

        from terrain_diffusion_tpu_torch import use_full_f32
        from terrain_diffusion_tpu_torch.ops import fused_block as fb
    except ImportError as e:
        fail(f"run from the root of a checkout of the repository ({e})")
    card = card_line()
    print(f"[card] {card}; torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    use_full_f32()
    dev = torch.device("cuda", 0)

    t0 = time.perf_counter()
    path = fb.build_kernels()
    print(f"[build] {os.path.relpath(path, ROOT)} in {time.perf_counter() - t0:.1f} s",
          flush=True)
    for line in fb.build_log.splitlines():
        if "registers" in line or "spill" in line:
            print(f"[build] {line.strip()}")

    rows = kernel_phase(torch, fb, dev)
    models = build_models(torch, dev)
    model_phase(torch, models[2], dev)
    launches = serving_phase(torch, np, fb, models, dev)

    report = []
    meta = {"fused_block": ("terrain_diffusion_tpu_torch/csrc/fused_block.cu",
                            "terrain_diffusion_tpu/ops/pallas_block.py:420",
                            "enc 512x512 64->64 b2"),
            "conv3x3": ("terrain_diffusion_tpu_torch/csrc/conv3x3.cu",
                        "terrain_diffusion_tpu/ops/pallas_block.py:595",
                        "out conv 512x512 64->1 b2")}
    for kernel, (source, replaces, case) in meta.items():
        mine = [r for r in rows if r["kernel"] == kernel]
        main_case = next(r for r in mine if r["case"] == case)
        report.append({"name": kernel, "route": "cuda", "source": source,
                       "replaces": replaces, "launches": launches[kernel],
                       "max_abs_err": max(r["max_abs_err"] for r in mine),
                       "ms": main_case["ms"], "plain_ms": main_case["plain_ms"],
                       "case": case})
    print(json.dumps({"kernels": report}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
