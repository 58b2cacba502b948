"""Work counts and peaks: the yardstick of ``mfu`` and the forward rooflines.

Frozen copies of ``chip_smoke.py``'s ``unet_forward_flops``, ``block_work``,
``conv_work`` and ``attn_work`` (written over the reference U-Net's plan and
shapes, so a count does not depend on what implements the work), shared by
every world kind; which stage windows the served tiles needed, and the FLOPs
of one, are the kind's (``worlds/<kind>.py``).
"""
from __future__ import annotations

from reference.unet import plan

# NVIDIA H100 SXM5 data sheet, dense, at the 700 W limit
PEAKS = {
    "bf16_flops": 989e12,          # bf16 / fp16 tensor cores
    "tf32_flops": 495e12,          # TF32 tensor cores
    "fp32_flops": 495e12 / 3,      # a product accurate to float32: three TF32 passes
    "hbm_bytes": 3.35e12,          # HBM3 bandwidth, bytes/s
}
PEAK_FLOPS = {"fp32": PEAKS["fp32_flops"], "bf16": PEAKS["bf16_flops"]}
ELEMENT_BYTES = {"fp32": 4, "bf16": 2}


def _levels(cfg: dict, h: int):
    """(name, kind, cin, cout, opts, res) of every plan entry at input size h."""
    enc, dec, final_ch, out_ch, emb, _ = plan(cfg)
    scale = h / cfg["image_size"]
    for name, kind, cin, cout, opts in enc + dec:
        yield name, kind, cin, cout, opts, int(int(name.split("x")[0]) * scale)


def unet_forward_flops(cfg: dict, n: int, h: int) -> float:
    """FLOPs of one U-Net forward of n images of h x h pixels: every 3x3 and
    1x1 conv (2 x weights x output pixels) and the attention products; the
    embedding linears and the elementwise work are left out."""
    _, _, final_ch, out_ch, _, _ = plan(cfg)
    total = 2 * 9 * final_ch * out_ch * n * h * h
    for _name, kind, cin, cout, opts, res in _levels(cfg, h):
        px = n * res * res
        if kind == "conv":
            total += 2 * 9 * cin * cout * px
            continue
        c0 = cout if opts.get("mode") == "enc" else cin
        total += 2 * 9 * (c0 * cout + cout * cout) * px
        if cin != cout:
            total += 2 * cin * cout * px
        heads = cout // (cfg.get("block_kwargs") or {}).get("channels_per_head", 64) \
            if opts.get("attention") else 0
        if heads > 0:
            total += 2 * (3 * cout * cout + cout * cout) * px
            total += 4 * n * (res * res) ** 2 * cout
    return float(total)


def block_work(px, cin, cmid, cout, mode, elt, n, cx=None, cskip=None, up=False):
    """(FLOPs, bytes) of one residual block: both 3x3 convs and the 1x1
    projection; each input read once, the output written once."""
    cin0 = cout if mode == "enc" else cin
    flops = 2 * 9 * px * (cin0 * cmid + cmid * cout)
    if cin != cout:
        flops += 2 * px * cin * cout
    x_px = px // 4 if up else px
    inputs = x_px * (cx if cx is not None else cin) + (px * cskip if cskip else 0)
    weights = 9 * (cin0 * cmid + cmid * cout) + (cin * cout if cin != cout else 0)
    return flops, (inputs + px * cout + weights) * elt + n * cmid * 4


def conv_work(px, cin, cout, k, elt):
    return 2 * k * k * px * cin * cout, (px * (cin + cout) + k * k * cin * cout) * elt


def attn_work(n, hw, c, elt):
    """QK^T and PV over every head; qkv read once, the output written once."""
    return 4 * n * hw * hw * c, (n * hw * 3 * c + n * hw * c) * elt


def forward_ops(cfg: dict, n: int, h: int, dtype: str) -> list:
    """(FLOPs, bytes) of each conv, block and attention op of one forward."""
    elt = ELEMENT_BYTES[dtype]
    enc, _, final_ch, out_ch, _, _ = plan(cfg)
    cph = (cfg.get("block_kwargs") or {}).get("channels_per_head", 64)
    ops, skips = [], []
    for k, (name, kind, cin, cout, opts, res) in enumerate(_levels(cfg, h)):
        px = n * res * res
        if kind == "conv":
            ops.append(conv_work(px, cin, cout, 3, elt))
        else:
            cskip = skips.pop() if k >= len(enc) and "block" in name else None
            ops.append(block_work(px, cin, cout, cout, opts.get("mode"), elt, n,
                                  cx=cin - cskip if cskip else None, cskip=cskip,
                                  up=opts.get("resample_mode") == "up"))
            if opts.get("attention") and cout // cph > 0:
                ops += [conv_work(px, cout, 3 * cout, 1, elt), attn_work(n, res * res, cout, elt),
                        conv_work(px, cout, cout, 1, elt)]
        if k < len(enc):
            skips.append(cout)
    ops.append(conv_work(n * h * h, final_ch, out_ch, 3, elt))
    return ops


def roofline_s(cfg: dict, n: int, h: int, dtype: str) -> float:
    """The least time the card could take for one forward: per op, the larger
    of FLOPs over the type's peak and bytes over the HBM rate, summed."""
    peak = PEAK_FLOPS[dtype]
    return sum(max(f / peak, b / PEAKS["hbm_bytes"]) for f, b in forward_ops(cfg, n, h, dtype))


def useful_flops(windows: dict, per_window: dict) -> float:
    return float(sum(len(windows[s]) * per_window[s] for s in per_window))
