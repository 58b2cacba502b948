"""A model of the conv kernels' arithmetic (``csrc/conv3x3.cuh``) and of the
attention's tensor-core kernel (``csrc/attention.cu``,
``pixelnorm_attention_tc``) in torch on the CPU: TF32 rounding, the 3xTF32
split and the order in which the kernels accumulate their products, held
against a float64 conv and the float64 attention.

The card rounds with ``cvt.rna.tf32.f32`` (nearest, ties away from zero, to
10 mantissa bits); the model does it by integer bit masking.  The kernel
splits each operand into big = tf32(x) and small = tf32(x - big) and adds,
per k8 step, small*big + big*small + big*big into float32 accumulators,
walking K as (16-channel chunk, tap, k8 step).  Products of two TF32 values
are exact in float32, so float32 matmuls of the split operands reproduce the
tensor cores' products.

Tolerances (max|diff| / max|ref| against the float64 conv or attention):
- ``REL_3XTF32 = 1e-5``: the 3xTF32 form must be float32-grade (only
  small*small, ~2^-22 relative, is dropped, plus float32 accumulation);
- ``REL_ATTENTION = 2e-6``: the attention model, float32-grade: the plain
  float32 attention reads 4e-7 to 9e-7 from float64 on these inputs;
- ``KERNEL_BAR = 1e-4``: the bar the kernels are held to on the card; a
  single TF32 pass (~2^-11 relative per operand) must miss it, which is why
  the kernels do not take one.
"""
import math

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from terrain_diffusion_tpu_torch.ops.attention import pixelnorm_attention_reference

REL_3XTF32 = 1e-5
REL_ATTENTION = 2e-6
KERNEL_BAR = 1e-4
CK = 16  # the conv kernel's K chunk (input channels per staged chunk)
KT = 64  # the attention kernel's key chunk
LOG2E = 1.4426950408889634


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op torch thread while this module runs: six pytest-xdist
    workers share the CPU, and torch's default of a thread per core makes
    each small op wait on descheduled siblings."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tf32(x: torch.Tensor) -> torch.Tensor:
    """cvt.rna.tf32.f32: keep 10 mantissa bits, nearest, ties away from zero
    (adding half of the dropped 13 bits' range to the magnitude bits)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def split(x: torch.Tensor):
    big = tf32(x)
    return big, tf32(x - big)


def im2col(x: torch.Tensor) -> torch.Tensor:
    """(H, W, C) -> (H * W, 9, C): the SAME-padded 3x3 windows, tap-major."""
    h, w, _ = x.shape
    xp = F.pad(x, (0, 0, 1, 1, 1, 1))
    taps = [xp[dy:dy + h, dx:dx + w] for dy in range(3) for dx in range(3)]
    return torch.stack(taps, dim=2).reshape(h * w, 9, -1)


def kernel_model_conv(x: torch.Tensor, w: torch.Tensor, passes: str) -> torch.Tensor:
    """The kernel's conv of (H, W, Cin) x with HWIO w, float32, K walked as
    (chunk, tap, k8); passes = "3xtf32" or "tf32" (one pass, big * big)."""
    a = im2col(x)                       # (P, 9, Cin)
    b = w.reshape(9, w.shape[2], -1)    # (9, Cin, Cout)
    acc = torch.zeros((a.shape[0], b.shape[2]), dtype=torch.float32)
    for c0 in range(0, a.shape[2], CK):
        for tap in range(9):
            for k0 in range(c0, min(c0 + CK, a.shape[2]), 8):
                ab, as_ = split(a[:, tap, k0:k0 + 8])
                bb, bs = split(b[tap, k0:k0 + 8])
                if passes == "3xtf32":
                    acc += as_ @ bb
                    acc += ab @ bs
                acc += ab @ bb
    return acc


def _case(cin, cout, silu_input, seed=0, size=16):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((size, size, cin)).astype(np.float32)
    if silu_input:  # conv0 sees silu of a pixel-normed input
        x = x / (1.0 + np.exp(-x))
    w = (rng.standard_normal((3, 3, cin, cout)) / np.sqrt(9 * cin)).astype(np.float32)
    x, w = torch.from_numpy(x), torch.from_numpy(w)
    exact = F.conv2d(x.double().permute(2, 0, 1)[None], w.double().permute(3, 2, 0, 1),
                     padding=1)[0].permute(1, 2, 0).reshape(size * size, cout)
    return x, w, exact


def _rel(got, exact):
    return float((got.double() - exact).abs().max() / exact.abs().max())


def test_tf32_rounding_is_nearest_ties_away():
    ulp = 2.0 ** -10  # TF32's unit in the last place at 1.0
    x = torch.tensor([1 + ulp / 2, -(1 + ulp / 2), 1 + ulp / 2 - 2 ** -23,
                      1 + 3 * ulp / 2, 3.0, 0.0], dtype=torch.float32)
    want = torch.tensor([1 + ulp, -(1 + ulp), 1.0, 1 + 2 * ulp, 3.0, 0.0],
                        dtype=torch.float32)
    assert torch.equal(tf32(x), want)
    # against rounding in float64: mantissa m in [0.5, 1) times 2^11, half away
    rng = np.random.default_rng(1)
    v = (rng.standard_normal(100_000) * 10.0 ** rng.integers(-6, 6, 100_000)).astype(np.float32)
    m, e = np.frexp(v.astype(np.float64))
    ref = np.sign(m) * np.floor(np.abs(m) * 2 ** 11 + 0.5) * 2.0 ** (e - 11)
    assert np.array_equal(tf32(torch.from_numpy(v)).numpy().astype(np.float64), ref)


def test_split_keeps_all_but_2_to_the_minus_22():
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.standard_normal(100_000).astype(np.float32))
    big, small = split(x)
    for part in (big, small):  # both are TF32 values: the 13 low bits are 0
        assert int((part.view(torch.int32) & 0x1FFF).abs().max()) == 0
    resid = (x.double() - big.double() - small.double()).abs()
    assert bool((resid <= 2.0 ** -22 * x.double().abs()).all())
    assert float(((x - big).abs() / x.abs()).max()) <= 2.0 ** -11


@pytest.mark.parametrize("cin,cout,silu_input", [
    (256, 64, True),   # K = 9 * 256: the 256-channel level
    (256, 8, False),
    (64, 64, True),    # the 512x512 level
    (6, 64, False),    # the input conv: one ragged chunk
])
def test_three_pass_conv_holds_f32_level(cin, cout, silu_input):
    x, w, exact = _case(cin, cout, silu_input)
    rel = _rel(kernel_model_conv(x, w, "3xtf32"), exact)
    assert rel < REL_3XTF32, rel


@pytest.mark.parametrize("cin,cout", [(256, 64), (64, 64)])
def test_one_tf32_pass_misses_the_kernel_bar(cin, cout):
    x, w, exact = _case(cin, cout, True)
    rel = _rel(kernel_model_conv(x, w, "tf32"), exact)
    assert rel > KERNEL_BAR, rel


def _product(a: torch.Tensor, b: torch.Tensor, passes: str) -> torch.Tensor:
    """a @ b over one k8 step, as the kernel's fresh fragment: small*big +
    big*small + big*big in 3xTF32, or big*big alone in one TF32 pass."""
    ab, as_ = split(a.contiguous())
    bb, bs = split(b.contiguous())
    if passes == "3xtf32":
        return as_ @ bb + ab @ bs + ab @ bb
    return ab @ bb


def kernel_model_attention(qkv: torch.Tensor, heads: int, passes: str,
                           eps: float = 1e-4) -> torch.Tensor:
    """The tensor-core kernel's attention of (N, H, W, 3C) float32 qkv,
    float32: per-pixel scales 1 / (eps + ||x|| / sqrt(ch)); S = q k^T of the
    raw q and k in k8 steps, each step a fresh fragment added into float32,
    then times the query scale (with log2(e) / sqrt(ch) folded in) and the
    key scale; an online softmax in exp2 over chunks of 64 keys, each chunk's
    two halves of 32 keys in two separate running states (the kernel's two
    warps per query row), rescaling the output per chunk; O += (P times the
    value scales) v over groups of 8 keys, P split too; the two states
    merged at the end.  The kernel starts each block's walk at its own
    chunk; the model walks from chunk 0, another order of the same sums."""
    n, h, w, c3 = qkv.shape
    c = c3 // 3
    ch, hw = c // heads, h * w
    y = qkv.reshape(n, hw, heads, ch, 3).permute(0, 2, 1, 4, 3)  # (N, heads, HW, 3, ch)
    norm_scale = torch.tensor(1.0 / math.sqrt(ch), dtype=torch.float32)
    scale = 1.0 / (eps + torch.sqrt((y * y).sum(-1)) * norm_scale)  # (N, heads, HW, 3)
    qs = scale[..., 0] * torch.tensor(LOG2E / math.sqrt(ch), dtype=torch.float32)
    q, k, v = y[..., 0, :], y[..., 1, :], y[..., 2, :]
    m = [torch.full((n, heads, hw), -math.inf) for _ in range(2)]
    l = [torch.zeros((n, heads, hw)) for _ in range(2)]
    o = [torch.zeros((n, heads, hw, ch)) for _ in range(2)]
    for k0 in range(0, hw, KT):
        for half in range(2):
            lo = k0 + half * KT // 2
            kc, vc = k[:, :, lo:lo + KT // 2], v[:, :, lo:lo + KT // 2]
            if kc.shape[2] == 0:  # every key of this half is past HW
                continue
            s = torch.zeros((n, heads, hw, kc.shape[2]))
            for c0 in range(0, ch, 8):
                s = s + _product(q[..., c0:c0 + 8], kc[..., c0:c0 + 8].transpose(-1, -2), passes)
            s = s * qs[..., None] * scale[:, :, None, lo:lo + KT // 2, 1]
            m_new = torch.maximum(m[half], s.amax(-1))
            alpha = torch.exp2(m[half] - m_new)
            p = torch.exp2(s - m_new[..., None])
            l[half] = l[half] * alpha + p.sum(-1)
            pv = p * scale[:, :, None, lo:lo + KT // 2, 2]
            acc = o[half] * alpha[..., None]
            for j0 in range(0, kc.shape[2], 8):
                acc = acc + _product(pv[..., j0:j0 + 8], vc[:, :, j0:j0 + 8], passes)
            o[half], m[half] = acc, m_new
    m_all = torch.maximum(m[0], m[1])
    a0, a1 = torch.exp2(m[0] - m_all), torch.exp2(m[1] - m_all)
    out = (o[0] * a0[..., None] + o[1] * a1[..., None]) / (l[0] * a0 + l[1] * a1)[..., None]
    return out.permute(0, 2, 1, 3).reshape(n, h, w, c)


def _attention_case(shape, seed=3):
    rng = np.random.default_rng(seed)
    return torch.from_numpy((rng.standard_normal(shape) * 3.0).astype(np.float32))


@pytest.mark.parametrize("shape,heads", [
    ((4, 8, 8, 2304), 12),  # the base model's midblock: one chunk per head
    ((1, 32, 64, 576), 3),  # HW = 2048: 32 chunks, the online rescale
    ((2, 5, 13, 96), 2),    # HW = 65, ch = 16: a ragged chunk of one key
])
def test_attention_model_holds_f32_level(shape, heads):
    qkv = _attention_case(shape)
    exact = pixelnorm_attention_reference(qkv.double(), heads)
    rel = _rel(kernel_model_attention(qkv, heads, "3xtf32"), exact)
    assert rel < REL_ATTENTION, rel


def test_attention_one_tf32_pass_misses_the_kernel_bar():
    qkv = _attention_case((4, 8, 8, 2304))
    exact = pixelnorm_attention_reference(qkv.double(), 12)
    rel = _rel(kernel_model_attention(qkv, 12, "tf32"), exact)
    assert rel > KERNEL_BAR, rel
