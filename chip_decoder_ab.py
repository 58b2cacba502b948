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
work out.  It prints each run's times and, per type and batch, the median
of each side.  Without a card it exits non-zero.
"""
import importlib.util
import json
import os
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.abspath(__file__))
CASES = [("float32", 2), ("float32", 16), ("bfloat16", 2), ("bfloat16", 16)]
REPEATS = 3


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
    out = {"package": os.path.dirname(pkg.__file__), "ms": {}, "device_ms": {}}
    for dtype, n in CASES:
        dt = getattr(torch, dtype)
        x = torch.randn((n, 512, 512, 5), generator=g).to(dev, dt)
        nl = torch.full((n,), 1.2, device=dev, dtype=dt)
        with torch.no_grad():
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
    print("RESULT " + json.dumps(out), flush=True)


def main():
    if len(sys.argv) >= 3 and sys.argv[1] == "--child":
        child(os.path.abspath(sys.argv[2]))
        return
    if len(sys.argv) < 2:
        sys.exit(__doc__)
    roots = {"parent": os.path.abspath(sys.argv[1]),
             "change": os.path.abspath(sys.argv[2] if len(sys.argv) > 2 else ROOT)}
    runs = []
    for side in ("parent", "change", "change", "parent") * 2:
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
            for k, v in res["ms"].items()), flush=True)
    for metric in ("ms", "device_ms"):
        for dtype, n in CASES:
            key = f"{dtype} b{n}"
            vals = {side: [t for s, r in runs if s == side for t in r[metric][key]]
                    for side in roots}
            med = {side: statistics.median(v) for side, v in vals.items()}
            print(f"[ab] decoder forward 512x512 {key} {metric}: median parent "
                  f"{med['parent']:.2f} ({min(vals['parent']):.2f}-{max(vals['parent']):.2f}), "
                  f"change {med['change']:.2f} ({min(vals['change']):.2f}-"
                  f"{max(vals['change']):.2f}), {med['change'] / med['parent'] - 1:+.1%}",
                  flush=True)


if __name__ == "__main__":
    main()
