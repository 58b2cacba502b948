"""The decoder's two narrow 3x3 convs as their CUDA kernels compute them, and
the 16-bit pixel-norm attention at a width off the tensor-core path, on the
CPU.

The kernels themselves run only on the card (tests/test_torch_cuda_kernels.py
holds them against their plain versions there).  Here each kernel's
arithmetic order is written in plain torch and held against
``conv3x3_reference`` (max|diff| / max|ref| < 1e-5 on the float32 sums: the
order differs from the CPU conv's) and against the JAX Pallas conv in
interpret mode at the bars of tests/test_torch_bf16.py:

- the head (``csrc/conv3x3.cuh::conv3x3_head_kernel``): a group of lp lanes
  owns a pixel's channels in 16-byte words of V values (8 in 16 bits, 4 in
  float32), lp the smallest power of two up to 8 that covers the words, each
  lane words gl, gl + lp, ...; a lane sums float32 FMAs over input rows dy,
  then its words, then the word's channels, then dx, and the lanes' sums
  meet in a shuffle butterfly;
- the 16-bit in conv (``csrc/conv_wgmma.cuh::in_conv16_kernel``): one GEMM
  with K = 9 taps x 8 channels (Cin padded with zeros) padded to 80, tap
  2s and 2s + 1 in k16 step s, the weight packed from the wrappers' K-major
  (9, Cout, Cin) layout into (Cout, 80) rows; 16-bit operands, float32 sums,
  one rounding on output.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from terrain_diffusion_tpu.ops import pallas_attention as pa
from terrain_diffusion_tpu.ops import pallas_block as pb
from terrain_diffusion_tpu_torch import use_full_f32
from terrain_diffusion_tpu_torch.ops import attention
from terrain_diffusion_tpu_torch.ops import fused_block as fb
from terrain_diffusion_tpu_torch.ops.nhwc import conv2d_nhwc, hwio_to_oihw

use_full_f32()
SUM_TOL = 1e-5
TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2, torch.float16: 2.5e-3}
JDT = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16, torch.float16: jnp.float16}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op torch thread while this module runs: six pytest-xdist
    workers share the CPU, and torch's default of a thread per core makes
    each small op wait on descheduled siblings."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _inputs(rng, n, h, w, cin, cout, dtype):
    x = torch.from_numpy(rng.standard_normal((n, h, w, cin)).astype(np.float32)).to(dtype)
    wt = torch.from_numpy((rng.standard_normal((3, 3, cin, cout)) * (9 * cin) ** -0.5)
                          .astype(np.float32))
    return x, wt


def _sums(x, wt):
    """The float32 sums of the conv on the kernel's operands (16-bit weights
    rounded to x's type), summed by the CPU's conv."""
    wr = wt if x.dtype == torch.float32 else wt.to(x.dtype).float()
    return conv2d_nhwc(x.float(), hwio_to_oihw(wr), padding=1)


def _pallas(x, wt):
    want = pb.fused_conv3x3_apply(jnp.asarray(x.float().numpy(), JDT[x.dtype]),
                                  jnp.asarray(wt.numpy()), interpret=True)
    return np.asarray(want.astype(jnp.float32))


def _fma(acc, a, b):
    """float32 fma(a, b, acc): the product exact in float64, one rounding
    (a double rounding in rare ties, which the bars absorb)."""
    return (acc.double() + a.double() * b.double()).float()


def head_model(x, wt):
    """conv3x3_head_kernel's float32 sums (N, H, W, Cout) and its output,
    the sums rounded once to x's type."""
    n, h, w, cin = x.shape
    cout = wt.shape[3]
    v = 16 // x.element_size()
    words = -(-cin // v)
    lp = 1
    while lp < 8 and lp < words:
        lp *= 2
    wpl = -(-words // lp)
    cfull = lp * wpl * v
    xp = torch.zeros((n, h + 2, w + 2, cfull))
    xp[:, 1:-1, 1:-1, :cin] = x.float()
    wr = wt if x.dtype == torch.float32 else wt.to(x.dtype).float()
    wp = torch.zeros((3, 3, cfull, cout))
    wp[:, :, :cin] = wr
    lanes = torch.arange(lp)
    acc = torch.zeros((n, h, w, cout, lp))
    for dy in range(3):          # input rows oy - 1, oy, oy + 1, as they stream in
        for wi in range(wpl):    # the lane's words gl + wi * lp
            for k in range(v):   # the word's channels
                for dx in range(3):
                    chan = (lanes + wi * lp) * v + k                    # (lp,)
                    xs = xp[:, dy:dy + h, dx:dx + w][..., chan]         # (N, H, W, lp)
                    ws = wp[dy, dx][chan].t()                           # (Cout, lp)
                    acc = _fma(acc, xs[:, :, :, None, :], ws)
    off = lp // 2
    while off:                   # the shuffle butterfly: acc += shfl_xor(acc, off)
        acc = acc + acc[..., lanes ^ off]
        off //= 2
    sums = acc[..., 0].contiguous()
    assert torch.equal(acc, sums[..., None].expand_as(acc))  # every lane holds the sum
    return sums, sums.to(x.dtype)


def in_conv_model(x, wt):
    """in_conv16_kernel's float32 sums and its output (rounded once to x's
    type): the K-major weight packed into (Cout, 80) rows, the A rows
    gathered per tap, five k16 steps."""
    n, h, w, cin = x.shape
    cout = wt.shape[3]
    wk = fb._k_major(wt, x.dtype)                     # (9, Cout, Cin), as the wrapper passes it
    packed = torch.zeros((cout, 80))                  # column tap * 8 + c
    for tap in range(9):
        packed[:, tap * 8:tap * 8 + cin] = wk[tap].float()
    xp = torch.zeros((n, h + 2, w + 2, 8))
    xp[:, 1:-1, 1:-1, :cin] = x.float()
    a = torch.zeros((n, h, w, 80))
    for tap in range(9):
        dy, dx = divmod(tap, 3)
        a[..., tap * 8:tap * 8 + 8] = xp[:, dy:dy + h, dx:dx + w]
    acc = torch.zeros((n, h, w, cout))
    for s in range(5):           # k16 step s: taps 2s and 2s + 1 (the tenth is zero)
        acc = acc + a[..., 16 * s:16 * s + 16] @ packed[:, 16 * s:16 * s + 16].t()
    return acc, acc.to(x.dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16],
                         ids=["f32", "bf16", "fp16"])
@pytest.mark.parametrize("cin,cout,shape", [
    (64, 1, (2, 9, 21)),      # the decoder head: one word a lane (16 bits), two (float32)
    (32, 3, (1, 7, 13)),      # the guide's 32-channel head, Cout 3
    (20, 8, (1, 5, 11)),      # a ragged last word, idle lanes (16 bits), Cout 8
])
def test_head_model_equals_the_plain_conv(rng, dtype, cin, cout, shape):
    x, wt = _inputs(rng, *shape, cin, cout, dtype)
    sums, got = head_model(x, wt)
    assert _rel(sums, _sums(x, wt)) < SUM_TOL
    want = fb.conv3x3_reference(x, wt)
    assert got.dtype == want.dtype == dtype
    assert _rel(got.float(), want.float()) < TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_head_model_matches_pallas(rng, dtype):
    """At the decoder's head (64 -> 1), against the Pallas conv in
    interpret mode."""
    x, wt = _inputs(rng, 2, 16, 128, 64, 1, dtype)
    sums, got = head_model(x, wt)
    assert _rel(sums, _sums(x, wt)) < SUM_TOL
    assert _rel(got.float(), _pallas(x, wt)) < TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16], ids=["bf16", "fp16"])
@pytest.mark.parametrize("cin,cout,shape", [
    (6, 64, (2, 16, 128)),    # the decoder's in conv, at the Pallas test shape
    (6, 32, (1, 9, 13)),      # the guide's 6 -> 32, ragged
    (8, 16, (1, 5, 7)),       # a full 8-channel tap
    (2, 40, (1, 6, 9)),       # Cin 2, Cout off the 64-channel slice
])
def test_in_conv_model_equals_the_plain_conv(rng, dtype, cin, cout, shape):
    x, wt = _inputs(rng, *shape, cin, cout, dtype)
    sums, got = in_conv_model(x, wt)
    assert fb.conv16_path(3, cin, cout) == "in_conv"
    assert _rel(sums, _sums(x, wt)) < SUM_TOL
    want = fb.conv3x3_reference(x, wt)
    assert got.dtype == want.dtype == dtype
    assert _rel(got.float(), want.float()) < TOL[dtype]
    if shape == (2, 16, 128):
        assert _rel(got.float(), _pallas(x, wt)) < TOL[dtype]


def _pallas_attention(qkv, heads):
    """The Pallas attention kernel body in interpret mode, with its
    wrapper's layout transposes (ops/pallas_attention.py)."""
    from jax.experimental import pallas as pl

    n, h, w, c3 = qkv.shape
    c = c3 // 3
    ch, hw = c // heads, h * w
    y = jnp.transpose(qkv.reshape(n, hw, heads, ch, 3), (0, 2, 4, 3, 1))
    y = y.reshape(n * heads, 3 * ch, hw)
    out = pl.pallas_call(
        functools.partial(pa._attn_kernel, ch=ch, hw=hw, eps=1e-4),
        out_shape=jax.ShapeDtypeStruct((n * heads, ch, hw), y.dtype),
        grid=(n * heads,),
        in_specs=[pl.BlockSpec((1, 3 * ch, hw), lambda i: (i, 0, 0))],
        out_specs=pl.BlockSpec((1, ch, hw), lambda i: (i, 0, 0)),
        interpret=True,
    )(y)
    return jnp.transpose(out.reshape(n, heads, ch, hw), (0, 3, 1, 2)).reshape(n, h, w, c)


def test_bf16_attention_off_the_tensor_core_widths_matches_pallas(rng):
    """A bf16 qkv at 8 channels a head (the CUDA-core kernel's width on the
    card) takes the wrapper without TypeError; on the CPU it is the plain
    version, against the Pallas kernel in interpret mode at the bf16 bar."""
    qkv = (3.0 * rng.standard_normal((2, 8, 8, 48))).astype(np.float32)
    assert attention.attention_path(8) == "cuda_cores"
    got = attention.fused_pixelnorm_attention(torch.from_numpy(qkv).bfloat16(), 2)
    want = _pallas_attention(jnp.asarray(qkv, jnp.bfloat16), 2)
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    assert _rel(got.float().numpy(), want.astype(jnp.float32)) < 1e-2
