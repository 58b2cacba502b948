#!/usr/bin/env python3
"""Times the production-width decoder forward of two checkouts in turns on
one CUDA card, so that a change can be compared with its parent in one run.

    python3 chip_decoder_ab.py PARENT_DIR [CHANGE_DIR]

PARENT_DIR and CHANGE_DIR (default: this script's checkout) are roots of
checkouts of this repository.  The runs go parent, change, change, parent,
twice, each in a fresh process that imports ``terrain_diffusion_tpu_torch``
from its checkout (and builds that checkout's kernels), makes the decoder
of ``configs/diffusion_decoder/diffusion_decoder_64-3.cfg`` with seeded
random weights as ``chip_smoke.py`` does, and times one forward at 512x512,
batch 2 and 16, in float32 and bf16: eager, CUDA events around 3 forwards
after one warm-up, three times; and its device time, 5 forwards captured in
a CUDA graph and replayed (``chip_smoke.graph_ms``), which leaves the host
work out.  Each run also times the three kernel wrappers' host work a call
at the kernel table's main cases (``chip_smoke.host_ms``: 5 calls that
never wait for the card, five times): the block at enc 512x512 64->64 b2
in float32 and bf16, the out conv 512x512 64->1 b2, the attention at the
midblock 8x8 12x64 b64.  It prints each run's times and, per case, the
median of each side.  Each run also hashes (SHA-256) the output of every
forward and wrapper case on its fixed inputs, and the script prints whether
the two checkouts' outputs are bit-equal, case by case.  ``--once`` runs
parent and change once each.  Without a card it exits non-zero.
"""
import hashlib
import importlib.util
import json
import os
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.abspath(__file__))
CASES = [("float32", 2), ("float32", 16), ("bfloat16", 2), ("bfloat16", 16)]
REPEATS = 3
HOST_CASES = ("block f32 enc 512x512 64->64 b2", "block bf16 enc 512x512 64->64 b2",
              "conv f32 out 512x512 64->1 b2", "attention f32 midblock 8x8 12x64 b64")


def wrapper_calls(torch, dev, g):
    """The host cases' wrapper calls, on inputs from g."""
    from terrain_diffusion_tpu_torch.ops import attention as attn
    from terrain_diffusion_tpu_torch.ops import fused_block as fb

    x = torch.randn((2, 512, 512, 64), generator=g).to(dev)
    w0, w1 = (torch.randn((3, 3, 64, 64), generator=g).to(dev) / 24.0 for _ in range(2))
    c = torch.ones((2, 64), device=dev)
    head = torch.randn((3, 3, 64, 1), generator=g).to(dev) / 24.0
    qkv = torch.randn((64, 8, 8, 2304), generator=g).to(dev)
    xb = x.to(torch.bfloat16)
    return dict(zip(HOST_CASES, (
        lambda: fb.fused_block(x, w0, w1, c, mode="enc"),
        lambda: fb.fused_block(xb, w0, w1, c, mode="enc"),
        lambda: fb.conv3x3(x, head),
        lambda: attn.fused_pixelnorm_attention(qkv, 12))))


def digest(t) -> str:
    """SHA-256 of a tensor's bytes (a 16-bit tensor as its raw 16-bit words)."""
    import torch

    raw = t.detach().contiguous().cpu()
    if raw.dtype in (torch.bfloat16, torch.float16):
        raw = raw.view(torch.int16)
    return hashlib.sha256(raw.numpy().tobytes()).hexdigest()


def child(pkg_root: str):
    """Time the decoder forward of the package under pkg_root; print JSON."""
    sys.path = [pkg_root] + [p for p in sys.path if os.path.abspath(p or ".") != ROOT]
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    import torch

    import terrain_diffusion_tpu_torch as pkg

    if not torch.cuda.is_available():
        sys.exit("no CUDA card")
    pkg.use_full_f32()
    dev = torch.device("cuda", 0)
    decoder = smoke.build_models(torch, dev)[2]
    g = torch.Generator().manual_seed(smoke.SEED + 3)
    out = {"package": os.path.dirname(pkg.__file__), "ms": {}, "device_ms": {}, "sha256": {}}
    for dtype, n in CASES:
        dt = getattr(torch, dtype)
        x = torch.randn((n, 512, 512, 5), generator=g).to(dev, dt)
        nl = torch.full((n,), 1.2, device=dev, dtype=dt)
        with torch.no_grad():
            out["sha256"][f"decoder {dtype} b{n}"] = digest(decoder(x, nl, []))
            out["ms"][f"{dtype} b{n}"] = [smoke.time_ms(lambda: decoder(x, nl, []), iters=3)
                                          for _ in range(REPEATS)]
            try:
                dev_ms = smoke.graph_ms(lambda: decoder(x, nl, []))
            except RuntimeError as e:  # a forward that cannot be captured: eager times only
                print(f"no CUDA graph of the {dtype} b{n} forward: {e}", flush=True)
                dev_ms = float("nan")
            out["device_ms"][f"{dtype} b{n}"] = [dev_ms]
        del x
        torch.cuda.empty_cache()
    out["host_ms"] = {}
    with torch.no_grad():
        for key, call in wrapper_calls(torch, dev, g).items():
            out["sha256"][key] = digest(call())
            out["host_ms"][key] = [smoke.host_ms(call) for _ in range(5)]
    print("RESULT " + json.dumps(out), flush=True)


def main():
    if len(sys.argv) >= 3 and sys.argv[1] == "--child":
        child(os.path.abspath(sys.argv[2]))
        return
    once = "--once" in sys.argv
    args = [a for a in sys.argv[1:] if a != "--once"]
    if not args:
        sys.exit(__doc__)
    roots = {"parent": os.path.abspath(args[0]),
             "change": os.path.abspath(args[1] if len(args) > 1 else ROOT)}
    runs = []
    for side in ("parent", "change") if once else ("parent", "change", "change", "parent") * 2:
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--child", roots[side]],
                              cwd=roots[side], capture_output=True, text=True, timeout=900)
        line = next((ln for ln in proc.stdout.splitlines() if ln.startswith("RESULT ")), None)
        if proc.returncode != 0 or line is None:
            sys.exit(f"{side} run failed ({proc.returncode}):\n{proc.stdout[-3000:]}"
                     f"\n{proc.stderr[-3000:]}")
        res = json.loads(line[len("RESULT "):])
        runs.append((side, res))
        print(f"[ab] {side} ({res['package']}): " + "; ".join(
            f"{k} {', '.join(f'{t:.2f}' for t in v)} ms (device {res['device_ms'][k][0]:.2f})"
            for k, v in res["ms"].items()) + "; host a call " + "; ".join(
            f"{k} {', '.join(f'{t:.4f}' for t in v)} ms" for k, v in res["host_ms"].items()),
            flush=True)
    sums = {side: next(r["sha256"] for s, r in runs if s == side) for side in roots}
    for key, want in sums["parent"].items():
        print(f"[ab] outputs {key}: parent and change bit-equal "
              f"{'yes' if sums['change'].get(key) == want else 'NO'}", flush=True)
    for metric, keys in (("ms", [f"{d} b{n}" for d, n in CASES]),
                         ("device_ms", [f"{d} b{n}" for d, n in CASES]),
                         ("host_ms", HOST_CASES)):
        for key in keys:
            vals = {side: [t for s, r in runs if s == side for t in r[metric][key]]
                    for side in roots}
            med = {side: statistics.median(v) for side, v in vals.items()}
            what = "decoder forward 512x512" if metric != "host_ms" else "wrapper host a call,"
            f = ".4f" if metric == "host_ms" else ".2f"
            print(f"[ab] {what} {key} {metric}: median parent "
                  f"{med['parent']:{f}} ({min(vals['parent']):{f}}-{max(vals['parent']):{f}}), "
                  f"change {med['change']:{f}} ({min(vals['change']):{f}}-"
                  f"{max(vals['change']):{f}}), {med['change'] / med['parent'] - 1:+.1%}",
                  flush=True)


if __name__ == "__main__":
    main()
