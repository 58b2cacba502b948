"""The 16-bit fused block as its launches compute it, and the 16-bit conv
chooser's rule, on the CPU.

On the card a bf16 / fp16 block is a prep pass (gather, pixel norm, the
float32 xs and the rounded operands round(xs) and round(silu(xs))), the 1x1
projection, conv0 and conv1 (``ops/fused_block.py::fused_block``, with the
convs on the wgmma core of ``csrc/conv_wgmma.cuh``).  Here each launch is
written in plain torch, following the wrapper's 16-bit branches, and the
chain must equal ``fused_block_reference`` bit for bit (the same operations
on the same rounded operands); at a tiny width it is also held against the
JAX Pallas block in interpret mode at the bf16 / fp16 tolerances of
``tests/test_torch_bf16.py``.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from terrain_diffusion_tpu.ops import pallas_block as pb
from terrain_diffusion_tpu_torch import use_full_f32
from terrain_diffusion_tpu_torch.ops import fused_block as fb
from terrain_diffusion_tpu_torch.ops.nhwc import conv2d_nhwc, hwio_to_oihw

use_full_f32()
HALF = pytest.mark.parametrize("half", [torch.bfloat16, torch.float16], ids=["bf16", "fp16"])
TOL16 = {torch.bfloat16: 1e-2, torch.float16: 2.5e-3}
DECODER_CIN = (64, 128, 192, 256, 320, 384, 448)
DECODER_COUT = (64, 128, 192, 256)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op torch thread while this module runs: six pytest-xdist
    workers share the CPU, and torch's default of a thread per core makes
    each small op wait on descheduled siblings."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def launches16(x, w0, w1, c, wskip=None, x2=None, *, mode="enc", pixel_norm=True,
               res_balance=0.3, clip_act=256.0, concat_scales=None, pre_upsample=1):
    """The 16-bit block launch by launch, each in plain torch (float32 sums
    of the 16-bit operands, as the kernels take them)."""
    dt, f32 = x.dtype, torch.float32

    def rnd(t):
        return t.to(dt).to(f32)

    s1, s2 = concat_scales if x2 is not None else (1.0, 1.0)
    u = pre_upsample

    def prep(src, src2, up, norm):
        """-> (xs float32, round(xs), round(silu(xs)))"""
        v = src.to(f32)
        if src2 is not None:
            v = torch.cat([v * s1, src2.to(f32) * s2], dim=-1)
        if up == 2:
            v = v.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)
        if norm:
            v = v / (1e-4 + torch.sqrt(torch.mean(v * v, dim=-1, keepdim=True)))
        return v, v.to(dt), fb._silu(v).to(dt)

    def project(src16):
        return torch.matmul(src16.to(f32), rnd(wskip))

    def conv(a16, w):
        return conv2d_nhwc(a16.to(f32), hwio_to_oihw(rnd(w.to(f32) * fb.INV_SILU_GAIN)),
                           padding=1)

    gathered = x2 is not None or u == 2
    if mode == "enc" and wskip is None:
        xs, _, a = prep(x, x2, u, pixel_norm)
        xres = xs if (gathered or pixel_norm) else x.to(f32)
    elif mode == "enc":
        p = project(prep(x, x2, u, False)[1] if gathered else x)
        xs, _, a = prep(p, None, 1, pixel_norm)
        xres = xs if pixel_norm else p
    else:
        xs, xr, a = prep(x, x2, u, False)
        if wskip is not None:
            xres = project(xr if gathered else x)
        else:
            xres = xs if gathered else x.to(f32)
    h = conv(a, w0)  # conv0: gain + silu, rounded
    if c is not None:
        h = h * c.to(f32)[:, None, None, :]
    h = fb._silu(h).to(dt)
    y = conv(h, w1)  # conv1: residual mix + clip, rounded once
    res_a, res_b, res_norm = fb._residual_coeffs(res_balance)
    out = (xres * res_a + y * res_b) / res_norm
    if clip_act is not None:
        out = torch.clamp(out, -clip_act, clip_act)
    return out.to(dt).contiguous()


BLOCKS = {  # n, hs, cin, cout, mode, x2 concat, projection, pre-upsample, pixel norm
    "enc": (2, 12, 16, 16, "enc", False, False, 1, True),
    "enc_no_norm": (1, 9, 16, 16, "enc", False, False, 1, False),
    "enc_proj": (1, 10, 16, 32, "enc", False, True, 1, True),
    "enc_proj_x2": (1, 10, 16, 32, "enc", True, True, 1, True),
    "dec_x2_concat_proj": (2, 11, 16, 16, "dec", True, True, 1, False),
    "dec_x2_concat": (1, 11, 16, 32, "dec", True, False, 1, False),
    "dec_pre_up": (1, 6, 32, 32, "dec", False, False, 2, False),
    "dec_proj": (1, 9, 48, 16, "dec", False, True, 1, False),
    "dec_plain": (1, 9, 16, 16, "dec", False, False, 1, False),
}


def _block(rng, n, hs, cin, cout, mode, with_x2, proj, up, norm, dtype):
    cg = 2 * cin if with_x2 else cin
    c_main = cout if (mode == "enc" and proj) else cg

    def rand(*shape, scale=1.0):
        return torch.from_numpy((rng.standard_normal(shape) * scale).astype(np.float32))

    args = (rand(n, hs, hs, cin).to(dtype), rand(3, 3, c_main, cout, scale=(9 * c_main) ** -0.5),
            rand(3, 3, cout, cout, scale=(9 * cout) ** -0.5), rand(n, cout, scale=0.3) + 1.0,
            rand(cg, cout, scale=cg ** -0.5) if proj else None,
            rand(n, hs, hs, cin).to(dtype) if with_x2 else None)
    kw = dict(mode=mode, pixel_norm=norm, res_balance=0.3, clip_act=256.0,
              concat_scales=(0.7, 0.3) if with_x2 else None, pre_upsample=up)
    return args, kw


@HALF
@pytest.mark.parametrize("case", list(BLOCKS))
def test_block_launches_equal_the_plain_block(rng, case, half):
    """prep, projection, conv0 and conv1 in plain torch give the plain
    version's block bit for bit: the launches round where it rounds."""
    args, kw = _block(rng, *BLOCKS[case], half)
    got = launches16(*args, **kw)
    want = fb.fused_block_reference(*args, **kw)
    assert got.dtype == want.dtype == half
    assert torch.equal(got, want)


@HALF
@pytest.mark.parametrize("case", ["enc_proj_x2", "dec_x2_concat_proj"])
def test_block_launches_match_pallas(rng, case, half):
    """The launch chain against the JAX Pallas block in interpret mode, at a
    tiny width."""
    n, hs, cin, cout, mode, with_x2, proj, up, norm = BLOCKS[case]
    args, kw = _block(rng, n, 8, cin, cout, mode, with_x2, proj, up, norm, half)
    args = (args[0][:, :, :4].repeat(1, 1, 16, 1).contiguous(), *args[1:5],  # 8 x 64 maps
            None if args[5] is None else args[5][:, :, :4].repeat(1, 1, 16, 1).contiguous())
    jdt = {torch.bfloat16: jnp.bfloat16, torch.float16: jnp.float16}[half]

    def j(t, dtype=jnp.float32):
        return None if t is None else jnp.asarray(t.float().numpy(), dtype)

    want = pb.fused_block_apply(j(args[0], jdt), j(args[1]), j(args[2]), j(args[3]),
                                j(args[4]), j(args[5], jdt), interpret=True, **kw)
    got = launches16(*args, **kw)
    want = np.asarray(want.astype(jnp.float32), np.float64)
    rel = np.abs(got.double().numpy() - want).max() / np.abs(want).max()
    assert rel < TOL16[half]


@pytest.mark.parametrize("ks", [1, 3])
def test_every_decoder_width_takes_the_wgmma_core(ks):
    """Every block width pair the decoder sends: a 3x3 conv keeps its
    weights on chip up to 128 input channels and streams them above; a 1x1
    projection keeps them."""
    for cin in DECODER_CIN:
        for cout in DECODER_COUT:
            want = "wgmma_resident" if ks == 1 or cin <= 128 else "wgmma_streamed"
            assert fb.conv16_path(ks, cin, cout) == want, (ks, cin, cout)


@pytest.mark.parametrize("ks,cin,cout,path", [
    (3, 6, 64, "in_conv"),      # the decoder's in conv: 6 channels
    (3, 6, 32, "in_conv"),      # the 32-channel guide's in conv
    (3, 8, 40, "in_conv"),      # Cout a multiple of 8, off 64
    (3, 5, 64, "mma_sync"),     # odd Cin: 2-channel words would straddle pixels
    (3, 6, 36, "mma_sync"),     # Cout off 8: the TMA store's rows
    (1, 6, 64, "mma_sync"),     # a 1x1 conv of 6 channels
    (3, 64, 1, "head"),         # the 64 -> 1 head
    (3, 256, 8, "head"),
    (3, 33, 64, "mma_sync"),    # Cin off 16
    (3, 64, 40, "mma_sync"),    # Cout off 64
    (1, 32, 64, "wgmma_resident"),
    (3, 16, 64, "wgmma_resident"),
    (1, 1152, 64, "wgmma_resident"),  # 18 chunk-taps
    (1, 1168, 64, "mma_sync"),  # a 1x1 conv never streams
    (3, 129, 64, "mma_sync"),
    (3, 144, 64, "wgmma_streamed"),
])
def test_conv16_path(ks, cin, cout, path):
    assert fb.conv16_path(ks, cin, cout) == path
    assert fb.CONV16_PATHS.index(path) >= 0


def test_conv16_path_counts_chunk_taps():
    """Weights stay on chip while ks * ks * ceil(cin / 64) <= 18."""
    for ks in (1, 3):
        for cin in range(16, 2048, 16):
            taps = ks * ks * math.ceil(cin / 64)
            path = fb.conv16_path(ks, cin, 64)
            assert (path == "wgmma_resident") == (taps <= 18), (ks, cin, path)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_k_major_weight_layout(rng, dtype):
    """The 16-bit kernels' weight layout, made in one pass: the float32
    weight scaled in float32, rounded once, (taps, Cout, Cin) with K
    contiguous."""
    w = torch.from_numpy(rng.standard_normal((3, 3, 48, 64)).astype(np.float32))
    want = (w * fb.INV_SILU_GAIN).to(dtype).permute(0, 1, 3, 2).reshape(9, 64, 48)
    got = fb._k_major(w, dtype, fb.INV_SILU_GAIN)
    assert got.is_contiguous() and got.dtype == dtype
    assert torch.equal(got, want)
    assert torch.equal(fb._k_major(w.to(dtype), dtype), w.to(dtype).permute(0, 1, 3, 2)
                       .reshape(9, 64, 48))
