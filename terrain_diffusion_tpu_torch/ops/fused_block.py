"""The decoder's two hand-written CUDA kernels, their wrappers and their
plain PyTorch versions.

- ``fused_block``: one whole magnitude-preserving residual block at
  inference (``csrc/fused_block.cu``), the counterpart of
  ``terrain_diffusion_tpu.ops.pallas_block.fused_block_apply``.
- ``conv3x3``: a SAME-padded 3x3 conv with a prepared HWIO weight
  (``csrc/conv3x3.cu``), the counterpart of ``fused_conv3x3_apply``.

Both run their 3x3 convs and the block's 1x1 projection on a tensor-core
conv core; a conv to at most 8 channels (the 64 -> 1 head) runs a direct
conv on the CUDA cores that reads each input row once.  The activations'
type picks the form, as ``x.dtype`` does for the Pallas kernels:

- float32: implicit GEMM in 3xTF32 on ``mma.sync`` (``csrc/conv3x3.cuh``),
  float32 in and out (the JAX kernels' Precision.HIGHEST dots).  Bound on
  the H100 by 3 x FLOPs / 495 TFLOP/s.
- bfloat16 or float16: one pass of 16-bit products with float32 sums (the
  JAX kernels' native MXU passes), on the ``wgmma`` core fed by TMA
  (``csrc/conv_wgmma.cuh``) for ``Cin % 16 == 0`` and ``Cout % 64 == 0``,
  the in-conv kernel (one K = 80 GEMM on ``mma.sync``, its output tile
  written by one TMA store) for a 3x3 conv from at most 8 channels (even)
  to a multiple of 8, else a 16-bit ``mma.sync`` core; ``conv16_path``
  says which.  The
  weights (float32 parameters) are scaled in float32 and then rounded; the
  block rounds where ``pallas_block.py::_block_body`` rounds: the gather,
  pixel norm and residual ``xres`` stay float32, the projection's operand,
  ``silu(xs)``, ``h`` and the output are rounded to the 16-bit type, and
  the gain ``c`` stays float32.  The block's prep pass writes the rounded
  operands the convs read.  Bound by FLOPs / 989 TFLOP/s (the in conv and
  the head by their bytes).  Any other type raises TypeError.

``fused_block_reference`` / ``conv3x3_reference`` take the same arguments
and compute the same math, rounding at the same points, with ``F.conv2d``
and tensor ops in float32 (float64 for a float64 input, an exact oracle).
A wrapper uses its plain version only for a tensor that lies on the CPU;
for a CUDA tensor it launches its kernel or raises, and a 16-bit tensor
never goes to the float32 kernel.  On any device a wrapper raises
RuntimeError where autograd would record through an input (the kernels
define no backward, ``cuda_lib.refuse_autograd``).  Each wrapper counts its launches in a
plain integer attribute (``fused_block.launches``, ``conv3x3.launches``).

The kernels are built and loaded by ``ops/cuda_lib.py``.
"""
from __future__ import annotations

import math

import torch

from terrain_diffusion_tpu_torch.ops.cuda_lib import (DTYPE_CODES, check_input, check_rc,
                                                      count_launch, counted, kernel_dtype,
                                                      load, ptr, refuse_autograd, stream)
from terrain_diffusion_tpu_torch.ops.nhwc import conv2d_nhwc, hwio_to_oihw

INV_SILU_GAIN = 1.0 / 0.596  # mp_silu divisor, folded into the conv weights


# ---------------------------------------------------------------------------
# the 16-bit conv core's dispatch rule
# ---------------------------------------------------------------------------

# csrc/conv_wgmma.cuh: Conv16Path codes, and the rule's constants
CONV16_PATHS = ("head", "mma_sync", "wgmma_resident", "wgmma_streamed", "in_conv")
WGMMA_CK, WGMMA_BN, WGMMA_RESIDENT_CHUNK_TAPS = 64, 64, 18


def conv16_path(ks: int, cin: int, cout: int) -> str:
    """The core a 16-bit ``ks`` x ``ks`` conv from ``cin`` to ``cout``
    channels runs on the card (the C chooser's rule, ``tdt_conv16_path``):
    "head" (3x3 to at most 8 channels, CUDA cores), "in_conv" (3x3 from at
    most 8 channels, an even number, to a multiple of 8), "wgmma_resident" /
    "wgmma_streamed" (the wgmma core, for cin % 16 == 0 and cout % 64 == 0,
    with the weights kept in shared memory where ks * ks * ceil(cin / 64) <=
    18, else streamed with the input; a 1x1 conv streams never), else
    "mma_sync"."""
    if ks == 3 and cout <= 8:
        return "head"
    if ks == 3 and cin <= 8 and cin % 2 == 0 and cout % 8 == 0:
        return "in_conv"
    if cin % 16 or cout % WGMMA_BN:
        return "mma_sync"
    if ks * ks * -(-cin // WGMMA_CK) <= WGMMA_RESIDENT_CHUNK_TAPS:
        return "wgmma_resident"
    return "wgmma_streamed" if ks == 3 else "mma_sync"


def library_conv16_path(ks: int, cin: int, cout: int) -> str:
    """The core the built library's chooser gives the same conv
    (``tdt_conv16_path``); builds the library."""
    return CONV16_PATHS[load().tdt_conv16_path(ks, cin, cout)]


def _check_tma(name: str, t: torch.Tensor, ks: int, cin: int, cout: int):
    """The wgmma core reads its 16-bit input and weight through TMA, which
    takes 16-byte aligned rows, and the in-conv kernel copies its input as
    16-byte words: raise ValueError for an input off that alignment (cin %
    16 == 0 makes every wgmma row a multiple of 16 bytes)."""
    path = conv16_path(ks, cin, cout)
    if t.data_ptr() % 16 and (path.startswith("wgmma") or path == "in_conv"):
        raise ValueError(f"{name} must be 16-byte aligned: the {path} conv core reads it "
                         "as 16-byte words")


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


def _k_major(w: torch.Tensor, dtype, scale=None) -> torch.Tensor:
    """A (KS, KS, Cin, Cout) weight as the 16-bit kernels take it: times
    ``scale`` in float32 where given, rounded to ``dtype``, (KS * KS, Cout,
    Cin) with K contiguous; one pass over the weight."""
    ks, _, cin, cout = w.shape
    out = torch.empty((ks, ks, cout, cin), device=w.device, dtype=dtype)
    src = w.permute(0, 1, 3, 2)
    if scale is None:
        out.copy_(src)
    else:  # the product in float32, rounded once as it is stored
        torch.mul(src.float(), scale, out=out)
    return out.view(ks * ks, cout, cin)


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
    refuse_autograd("conv3x3", x, w)
    if x.device.type == "cpu":
        return conv3x3_reference(x, w)
    dt = kernel_dtype("x", x)
    check_input("x", x, x.device, 4, dt)
    _check_weight("w", w, x, 4)
    N, H, W, Cin = x.shape
    if tuple(w.shape[:3]) != (3, 3, Cin):
        raise ValueError(f"w shape {tuple(w.shape)} does not fit x {tuple(x.shape)}")
    Cout = w.shape[3]
    if dt != torch.float32:
        _check_tma("x", x, 3, Cin, Cout)
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
    refuse_autograd("fused_block", x, w0, w1, c, wskip, x2)
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
    gathered = x2 is not None or u == 2
    half = dt != torch.float32
    if half and wskip is not None and not gathered:  # the projection reads x itself
        _check_tma("x", x, 1, Cg, Cout)
    if c is None:
        c = torch.ones((N, Cmid), device=dev, dtype=torch.float32)
    check_input("c", c, dev, 2)
    if tuple(c.shape) != (N, Cmid):
        raise ValueError(f"c shape {tuple(c.shape)} != {(N, Cmid)}")
    if half:  # rounded after the scaling, laid out K-major
        w0, w1 = _k_major(w0, dt, INV_SILU_GAIN), _k_major(w1, dt, INV_SILU_GAIN)
        if wskip is not None:  # (Cout, Cin): one tap, K-major
            wskip = torch.empty((Cout, Cg), device=dev, dtype=dt).copy_(wskip.t())
    else:
        w0 = (w0.float() * INV_SILU_GAIN).contiguous()
        w1 = (w1.float() * INV_SILU_GAIN).contiguous()
    code = DTYPE_CODES[dt]
    lib = load()
    strm = stream(dev)
    f32 = torch.float32

    def prep(src, src2, up, norm, xs=False, xr=False, a=False):
        """concat / nearest-up / pixel norm: one memory-bound pass that
        writes the float32 xs and, in a 16-bit block, the operands round(xs)
        and round(silu(xs)), each where asked"""
        c_out = 2 * src.shape[3] if src2 is not None else src.shape[3]
        outs = [torch.empty((N, H, W, c_out), device=dev, dtype=t) if want else None
                for want, t in ((xs, f32), (xr, dt), (a, dt))]
        check_rc(lib.tdt_block_prep(
            src.data_ptr(), ptr(src2), int(src.dtype == f32), s1 if src2 is not None else 1.0,
            s2, int(up == 2), int(norm), *map(ptr, outs), N, H, W, src.shape[3], code, strm),
            "fused_block prep")
        return outs

    def project(src):
        """the 1x1 projection on the tensor-core conv core, float32 out"""
        out = torch.empty((N, H, W, Cout), device=dev, dtype=f32)
        check_rc(lib.tdt_block_proj(
            src.data_ptr(), int(src.dtype == f32), wskip.data_ptr(), out.data_ptr(),
            N, H, W, src.shape[3], Cout, code, strm), "fused_block projection")
        return out

    if not half:  # conv0 applies silu to the float32 xs
        if mode == "enc" and wskip is None:
            xs = prep(x, x2, u, pixel_norm, xs=True)[0] if (gathered or pixel_norm) else x
            xres = xs
        elif mode == "enc":
            xs = project(prep(x, x2, u, False, xs=True)[0] if gathered else x)
            xres = xs = prep(xs, None, 1, True, xs=True)[0] if pixel_norm else xs
        else:
            xs = prep(x, x2, u, False, xs=True)[0] if gathered else x
            xres = project(xs) if wskip is not None else xs
        a = xs
    elif mode == "enc" and wskip is None:  # 16-bit: conv0 reads a = round(silu(xs))
        keep = gathered or pixel_norm
        xs, _, a = prep(x, x2, u, pixel_norm, xs=keep, a=True)
        xres = xs if keep else x
    elif mode == "enc":
        p = project(prep(x, x2, u, False, xr=True)[1] if gathered else x)
        xs, _, a = prep(p, None, 1, pixel_norm, xs=pixel_norm, a=True)
        xres = xs if pixel_norm else p
    else:
        proj = wskip is not None
        xs, xr, a = prep(x, x2, u, False, xs=gathered and not proj, xr=gathered and proj,
                         a=True)
        xres = project(xr if gathered else x) if proj else (xs if gathered else x)
    h = torch.empty((N, H, W, Cmid), device=dev, dtype=dt)
    out = torch.empty((N, H, W, Cout), device=dev, dtype=dt)
    res_a, res_b, res_norm = _residual_coeffs(res_balance)
    check_rc(lib.tdt_block_conv0(
        a.data_ptr(), int(a.dtype == f32), w0.data_ptr(), c.data_ptr(), h.data_ptr(), N, H, W,
        a.shape[3], Cmid, code, strm), "fused_block conv0")
    check_rc(lib.tdt_block_conv1(
        h.data_ptr(), w1.data_ptr(), xres.data_ptr(), int(xres.dtype == f32), out.data_ptr(),
        N, H, W, Cmid, Cout, res_a, res_b, res_norm, int(clip_act is not None),
        float(clip_act) if clip_act is not None else 0.0, code, strm), "fused_block conv1")
    count_launch(fused_block, dt)
    return out
