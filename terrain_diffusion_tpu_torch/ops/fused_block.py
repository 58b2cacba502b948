"""The decoder's two hand-written CUDA kernels, their wrappers and their
plain PyTorch versions.

- ``fused_block``: one whole magnitude-preserving residual block at
  inference (``csrc/fused_block.cu``), the counterpart of
  ``terrain_diffusion_tpu.ops.pallas_block.fused_block_apply``.
- ``conv3x3``: a SAME-padded 3x3 conv with a prepared HWIO weight
  (``csrc/conv3x3.cu``), the counterpart of ``fused_conv3x3_apply``.

Both run their 3x3 convs and the block's 1x1 projection on one tensor-core
conv core (``csrc/conv3x3.cuh``); a conv to at most 8 channels (the 64 -> 1
head) runs a direct conv on the CUDA cores.  The activations' type picks the
form, as ``x.dtype`` does for the Pallas kernels:

- float32: implicit GEMM in 3xTF32, float32 in and out (the JAX kernels'
  Precision.HIGHEST dots).  Bound on the H100 by 3 x FLOPs / 495 TFLOP/s.
- bfloat16 or float16: one pass of 16-bit ``mma.sync`` with float32 sums
  (the JAX kernels' native MXU passes).  The weights (float32 parameters)
  are scaled in float32 and then rounded; the block rounds where
  ``pallas_block.py::_block_body`` rounds: the gather, pixel norm and
  residual ``xres`` stay float32, the projection's operand, ``silu(xs)``,
  ``h`` and the output are rounded to the 16-bit type, and the gain ``c``
  stays float32.  Bound by FLOPs / 989 TFLOP/s (the in conv and the head by
  their bytes).  Any other type raises TypeError.

``fused_block_reference`` / ``conv3x3_reference`` take the same arguments
and compute the same math, rounding at the same points, with ``F.conv2d``
and tensor ops in float32 (float64 for a float64 input, an exact oracle).
A wrapper uses its plain version only for a tensor that lies on the CPU;
for a CUDA tensor it launches its kernel or raises, and a 16-bit tensor
never goes to the float32 kernel.  Each wrapper counts its launches in a
plain integer attribute (``fused_block.launches``, ``conv3x3.launches``).

The kernels are built and loaded by ``ops/cuda_lib.py``.
"""
from __future__ import annotations

import math

import torch

from terrain_diffusion_tpu_torch.ops.cuda_lib import (DTYPE_CODES, check_input, check_rc,
                                                      count_launch, counted, kernel_dtype,
                                                      load, ptr, stream)
from terrain_diffusion_tpu_torch.ops.nhwc import conv2d_nhwc, hwio_to_oihw

INV_SILU_GAIN = 1.0 / 0.596  # mp_silu divisor, folded into the conv weights


# ---------------------------------------------------------------------------
# conv3x3
# ---------------------------------------------------------------------------

def _rounding(dtype):
    """(compute type, round): the plain versions compute in float32 (float64
    for a float64 input); round(t) is t rounded to a 16-bit ``dtype`` and
    back, and the identity otherwise."""
    ct = torch.promote_types(dtype, torch.float32)
    if ct == dtype:
        return ct, lambda t: t.to(ct)
    return ct, lambda t: t.to(dtype).to(ct)


def _k_major(w: torch.Tensor, dtype) -> torch.Tensor:
    """A (KS, KS, Cin, Cout) weight as the 16-bit kernels take it: rounded to
    ``dtype``, (KS * KS, Cout, Cin) with K contiguous."""
    ks, _, cin, cout = w.shape
    return w.to(dtype).permute(0, 1, 3, 2).reshape(ks * ks, cout, cin).contiguous()


def _check_weight(name, w, x, ndim):
    """A weight is float32 (the parameters) or already in x's type."""
    check_input(name, w, x.device, ndim, torch.float32 if w.dtype == torch.float32 else x.dtype)


def conv3x3_reference(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Plain version: SAME 3x3 conv of NHWC x with a prepared HWIO weight, in
    float32, or in float64 for a float64 input (an exact oracle).  A 16-bit
    x takes the weight rounded to its type, sums in float32 and returns its
    type."""
    dt, rnd = _rounding(x.dtype)
    y = conv2d_nhwc(x.to(dt), hwio_to_oihw(rnd(w)), padding=1)
    return (y if x.dtype == dt else y.to(x.dtype)).contiguous()


@counted
def conv3x3(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """SAME-padded 3x3 conv: x (N, H, W, Cin) float32, bfloat16 or float16, w (3, 3,
    Cin, Cout) prepared HWIO weight (normalized, fan-in scaled, gain folded;
    float32, or x's type); the output is in x's type."""
    if x.device.type == "cpu":
        return conv3x3_reference(x, w)
    dt = kernel_dtype("x", x)
    check_input("x", x, x.device, 4, dt)
    _check_weight("w", w, x, 4)
    N, H, W, Cin = x.shape
    if tuple(w.shape[:3]) != (3, 3, Cin):
        raise ValueError(f"w shape {tuple(w.shape)} does not fit x {tuple(x.shape)}")
    Cout = w.shape[3]
    lib = load()
    y = torch.empty((N, H, W, Cout), device=x.device, dtype=dt)
    wk = w if dt == torch.float32 else _k_major(w, dt)
    check_rc(lib.tdt_conv3x3(x.data_ptr(), wk.data_ptr(), y.data_ptr(), N, H, W, Cin, Cout,
                              DTYPE_CODES[dt], stream(x.device)), "conv3x3")
    count_launch(conv3x3, dt)
    return y


# ---------------------------------------------------------------------------
# fused residual block
# ---------------------------------------------------------------------------

def _silu(x):
    # bare x*sigmoid(x): the magnitude-preserving 1/0.596 is folded into
    # the following conv's weight
    return x / (1.0 + torch.exp(-x))


def _residual_coeffs(res_balance: float):
    t = float(res_balance)
    return 1.0 - t, t, math.sqrt((1.0 - t) ** 2 + t ** 2)


def fused_block_reference(x, w0, w1, c, wskip=None, x2=None, *, mode="enc",
                          pixel_norm=True, res_balance=0.3, clip_act=256.0,
                          concat_scales=None, pre_upsample=1):
    """Plain version of ``fused_block`` (same arguments, same math), in
    float32, or in float64 for a float64 ``x`` (an exact oracle).  A 16-bit
    ``x`` computes in float32 from its values and rounds to its type where
    the Pallas kernel does: the projection's operand and weight, silu(xs),
    both conv weights (after the 1/0.596 scaling), h and the output."""
    dt, rnd = _rounding(x.dtype)
    xs = x.to(dt)
    if x2 is not None:
        s1, s2 = concat_scales
        xs = torch.cat([xs * s1, x2.to(dt) * s2], dim=-1)
    if pre_upsample == 2:
        xs = xs.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)
    if mode == "enc":
        if wskip is not None:
            xs = torch.matmul(rnd(xs), rnd(wskip))
        if pixel_norm:
            rms = torch.sqrt(torch.mean(xs * xs, dim=-1, keepdim=True))
            xs = xs / (1e-4 + rms)
        xres = xs
    else:
        xres = torch.matmul(rnd(xs), rnd(wskip)) if wskip is not None else xs
    h = conv2d_nhwc(rnd(_silu(xs)), hwio_to_oihw(rnd(w0.to(dt) * INV_SILU_GAIN)), padding=1)
    if c is not None:
        h = h * c.to(dt)[:, None, None, :]
    y = conv2d_nhwc(rnd(_silu(h)), hwio_to_oihw(rnd(w1.to(dt) * INV_SILU_GAIN)), padding=1)
    a, b, norm = _residual_coeffs(res_balance)
    out = (xres * a + y * b) / norm
    if clip_act is not None:
        out = torch.clamp(out, -clip_act, clip_act)
    return (out if x.dtype == dt else out.to(x.dtype)).contiguous()


@counted
def fused_block(x, w0, w1, c, wskip=None, x2=None, *, mode="enc",
                pixel_norm=True, res_balance=0.3, clip_act=256.0,
                concat_scales=None, pre_upsample=1):
    """Fused residual-block forward (inference).

    x      : (N, H, W, Cin) activations, float32, bfloat16 or float16 (half
             resolution when pre_upsample=2); the output has x's type.
    w0     : (3, 3, Cin', Cmid) normalized + fan-in-scaled first conv weight;
             Cin' = Cout for enc blocks with a projection (which runs first),
             else the (concatenated) input width.
    w1     : (3, 3, Cmid, Cout) normalized + scaled second conv weight.
    c      : (N, Cmid) float32 per-channel emb gain (+1 and RMS-normalized),
             or None.
    wskip  : (Cin, Cout) normalized + scaled 1x1 projection, or None.
    x2     : optional second input of x's shape and type; with
             concat_scales=(s1, s2) the block consumes mp_concat([x, x2])
             (the dec skip join).

    Weights are float32 (or already in x's type).  The 1/0.596 mp_silu gain
    is folded into w0/w1 here, in float32 before any rounding, so callers
    pass plain normalized weights.
    """
    if x.device.type == "cpu":
        return fused_block_reference(
            x, w0, w1, c, wskip, x2, mode=mode, pixel_norm=pixel_norm,
            res_balance=res_balance, clip_act=clip_act,
            concat_scales=concat_scales, pre_upsample=pre_upsample)
    dev = x.device
    dt = kernel_dtype("x", x)
    u = int(pre_upsample)
    if u not in (1, 2):
        raise ValueError(f"pre_upsample must be 1 or 2, got {pre_upsample}")
    if mode not in ("enc", "dec"):
        raise ValueError(f"mode must be 'enc' or 'dec', got {mode!r}")
    check_input("x", x, dev, 4, dt)
    N, Hs, Ws, Cx = x.shape
    H, W = Hs * u, Ws * u
    Cg = Cx
    if x2 is not None:
        check_input("x2", x2, dev, 4, dt)
        if x2.shape != x.shape or concat_scales is None or u != 1:
            raise ValueError("x2 needs x's shape, concat_scales and pre_upsample=1")
        Cg = 2 * Cx
    s1, s2 = (float(concat_scales[0]), float(concat_scales[1])) \
        if x2 is not None else (1.0, 1.0)
    for name, t in (("w0", w0), ("w1", w1)):
        _check_weight(name, t, x, 4)
    Cmid, Cout = w0.shape[3], w1.shape[3]
    if wskip is not None:
        _check_weight("wskip", wskip, x, 2)
        if wskip.shape[0] != Cg:
            raise ValueError(f"wskip {tuple(wskip.shape)} does not fit {Cg} input channels")
    c_main = wskip.shape[1] if (mode == "enc" and wskip is not None) else Cg
    c_res = wskip.shape[1] if wskip is not None else Cg
    if tuple(w0.shape[:3]) != (3, 3, c_main) or tuple(w1.shape[:3]) != (3, 3, Cmid) \
            or c_res != Cout:
        raise ValueError("block weights do not fit the input: "
                         f"x {tuple(x.shape)}, w0 {tuple(w0.shape)}, "
                         f"w1 {tuple(w1.shape)}, wskip "
                         f"{None if wskip is None else tuple(wskip.shape)}")
    if c is None:
        c = torch.ones((N, Cmid), device=dev, dtype=torch.float32)
    check_input("c", c, dev, 2)
    if tuple(c.shape) != (N, Cmid):
        raise ValueError(f"c shape {tuple(c.shape)} != {(N, Cmid)}")
    w0 = w0.float() * INV_SILU_GAIN
    w1 = w1.float() * INV_SILU_GAIN
    if dt != torch.float32:  # rounded after the scaling, laid out K-major
        w0, w1 = _k_major(w0, dt), _k_major(w1, dt)
        if wskip is not None:
            wskip = wskip.to(dt).t().contiguous()  # (Cout, Cin): one tap, K-major
    else:
        w0, w1 = w0.contiguous(), w1.contiguous()
    code = DTYPE_CODES[dt]
    lib = load()
    strm = stream(dev)

    def gather(src, src2, up, norm):
        """concat / nearest-up / pixel norm: one memory-bound pass, float32 out"""
        c_src = src.shape[3]
        out = torch.empty((N, H, W, 2 * c_src if src2 is not None else c_src),
                          device=dev, dtype=torch.float32)
        check_rc(lib.tdt_block_gather(
            src.data_ptr(), ptr(src2), s1 if src2 is not None else 1.0, s2, int(up == 2),
            int(norm), out.data_ptr(), N, H, W, c_src, DTYPE_CODES[src.dtype], strm),
            "fused_block gather")
        return out

    def project(src):
        """the 1x1 projection on the tensor-core conv core, float32 out"""
        out = torch.empty((N, H, W, Cout), device=dev, dtype=torch.float32)
        check_rc(lib.tdt_block_proj(
            src.data_ptr(), int(src.dtype == torch.float32), wskip.data_ptr(), out.data_ptr(),
            N, H, W, src.shape[3], Cout, code, strm), "fused_block projection")
        return out

    gathered = x2 is not None or u == 2
    if mode == "enc" and wskip is None:
        xs = gather(x, x2, u, pixel_norm) if (gathered or pixel_norm) else x
        xres = xs
    elif mode == "enc":
        xs = project(gather(x, x2, u, False) if gathered else x)
        xres = xs = gather(xs, None, 1, True) if pixel_norm else xs
    else:
        xs = gather(x, x2, u, False) if gathered else x
        xres = project(xs) if wskip is not None else xs
    h = torch.empty((N, H, W, Cmid), device=dev, dtype=dt)
    out = torch.empty((N, H, W, Cout), device=dev, dtype=dt)
    a, b, norm = _residual_coeffs(res_balance)
    check_rc(lib.tdt_block_conv0(
        xs.data_ptr(), int(xs.dtype == torch.float32), w0.data_ptr(), c.data_ptr(),
        h.data_ptr(), N, H, W, xs.shape[3], Cmid, code, strm), "fused_block conv0")
    check_rc(lib.tdt_block_conv1(
        h.data_ptr(), w1.data_ptr(), xres.data_ptr(), int(xres.dtype == torch.float32),
        out.data_ptr(), N, H, W, Cmid, Cout, a, b, norm, int(clip_act is not None),
        float(clip_act) if clip_act is not None else 0.0, code, strm), "fused_block conv1")
    count_launch(fused_block, dt)
    return out
