"""The hand-written CUDA kernels (fused residual block, 3x3 conv, pixel-norm
attention) against their plain PyTorch versions, on the card.  Marked `cuda`: skipped where torch sees no CUDA device.

This file imports no JAX, so on a machine without it run it without the
repository conftest:
    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_kernels.py

Bar: max|diff| / max|ref| < 1e-4 - against the plain version in float32
(TF32 off), with another summation order, and against the same math in
float64 on the CPU.  Shapes are small and deliberately ragged (maps that are
not a multiple of the 8 x 16 pixel tile, channel counts off the tile
widths: Cin 5, 6, 33, Cout 1, 3, 8, 40).

The registered operators (``test_registered_operators_on_the_card``): each
kernel's operator, through the dispatcher, equals its launch code called
directly and its wrapper bit for bit; its Meta implementation gives the
output's shape and type.

The training path (``test_wrappers_refuse_autograd_on_the_card``,
``test_training_forward_on_the_card_takes_the_plain_path``): the wrappers
raise where autograd would record, and a training forward launches no
kernel and gives the CPU's gradients (bar 1e-4).

The 16-bit conv core on wgmma (``test_wgmma_core*``) is driven through the
block's C entry points with each epilogue, at every block width pair the
decoder sends, against the same products in float32 on the card.

The narrow head (``test_head_kernel*``) runs in float32, bf16 and fp16 at
Cin 32 and 64, Cout 1, 3 and 8, on maps that are no multiple of its strips
or runs, at batch 1, 2 and 16, and in the block's Cout <= 8 forms.  The
16-bit in conv (``test_in_conv16*``) runs 6 -> 32 and 6 -> 64 (and the other
shapes its rule takes) on the same maps and batches, and with the block's
epilogues through the C entry points.

The 16-bit forms (``*_16bit`` tests) take bf16 or fp16 activations:
against the plain version on the same inputs the bar is 1e-2 for bf16 and
2.5e-3 for fp16 (about 2.5 steps of the type at the largest value: both
round the same intermediates and the output, and sum in another order);
against the plain version in float64 on the CPU (no rounding at all) the
kernel's error may be at most 1.25 times the float32 plain version's own,
which both are dominated by the 16-bit roundings.
"""
import numpy as np
import pytest
import torch

from terrain_diffusion_tpu_torch import use_full_f32
from terrain_diffusion_tpu_torch.ops import attention
from terrain_diffusion_tpu_torch.ops import fused_block as fb

pytestmark = pytest.mark.cuda
TOL = 1e-4
TOL16 = {torch.bfloat16: 1e-2, torch.float16: 2.5e-3}
HALF = pytest.mark.parametrize("half", [torch.bfloat16, torch.float16], ids=["bf16", "fp16"])


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    use_full_f32()
    return torch.device("cuda")


def _rand(gen, shape, dev, scale=1.0):
    return (torch.randn(shape, generator=gen) * scale).to(dev)


def _rel(got, want):
    return float((got - want).abs().max() / (want.abs().max() + 1e-12))


@pytest.mark.parametrize(
    "n,h,w,cin,cout,mode,with_x2,preup,proj,clip",
    [
        (2, 40, 72, 32, 32, "enc", False, 1, False, 256.0),
        (1, 24, 40, 32, 64, "enc", False, 1, True, 256.0),
        (2, 40, 72, 32, 32, "dec", True, 1, True, 256.0),
        (2, 40, 72, 32, 64, "dec", True, 1, False, 256.0),
        (2, 20, 36, 32, 32, "dec", False, 2, False, 256.0),
        (1, 33, 47, 48, 64, "dec", False, 1, True, None),
        (1, 12, 20, 256, 256, "dec", False, 2, False, 256.0),  # 256-ch pre-up
        (1, 21, 37, 192, 64, "dec", False, 1, True, 256.0),    # 192->64 projection
        (2, 19, 27, 33, 40, "enc", False, 1, True, 256.0),     # Cin 33, Cout 40
    ])
def test_fused_block_kernel(dev, n, h, w, cin, cout, mode, with_x2, preup, proj, clip):
    g = torch.Generator().manual_seed(0)
    cg = 2 * cin if with_x2 else cin
    c_main = cout if (mode == "enc" and proj) else cg
    x = _rand(g, (n, h, w, cin), dev)
    x2 = _rand(g, (n, h, w, cin), dev) if with_x2 else None
    w0 = _rand(g, (3, 3, c_main, cout), dev, (9 * c_main) ** -0.5)
    w1 = _rand(g, (3, 3, cout, cout), dev, (9 * cout) ** -0.5)
    wskip = _rand(g, (cg, cout), dev, cg ** -0.5) if proj else None
    c = _rand(g, (n, cout), dev, 0.3) + 1.0
    kw = dict(mode=mode, pixel_norm=(mode == "enc"), res_balance=0.3, clip_act=clip,
              concat_scales=(0.7, 0.3) if with_x2 else None, pre_upsample=preup)
    before = fb.fused_block.launches
    got = fb.fused_block(x, w0, w1, c, wskip, x2, **kw)
    torch.cuda.synchronize()
    assert fb.fused_block.launches == before + 1
    want = fb.fused_block_reference(x, w0, w1, c, wskip, x2, **kw)
    assert got.shape == want.shape
    assert _rel(got, want) < TOL
    # and against the same math in float64 on the CPU, independent of cuDNN
    exact = fb.fused_block_reference(*(t.double().cpu() if t is not None else None
                                       for t in (x, w0, w1, c, wskip, x2)), **kw)
    assert _rel(got.double().cpu(), exact) < TOL


@pytest.mark.parametrize("n,h,w,cin,cout", [
    (1, 64, 64, 6, 64), (2, 64, 80, 64, 1), (1, 37, 53, 5, 3), (2, 30, 50, 33, 40),
    # off the 8 x 16 pixel tile in both axes, at the ragged widths
    (1, 21, 35, 6, 64), (2, 19, 27, 33, 1), (1, 13, 50, 6, 40), (1, 9, 17, 256, 8)])
def test_conv3x3_kernel(dev, n, h, w, cin, cout):
    g = torch.Generator().manual_seed(1)
    x = _rand(g, (n, h, w, cin), dev)
    wt = _rand(g, (3, 3, cin, cout), dev, (9 * cin) ** -0.5)
    before = fb.conv3x3.launches
    got = fb.conv3x3(x, wt)
    torch.cuda.synchronize()
    assert fb.conv3x3.launches == before + 1
    assert _rel(got, fb.conv3x3_reference(x, wt)) < TOL
    # and against a float64 reference on the CPU, independent of cuDNN
    x64 = x.double().cpu().permute(0, 3, 1, 2)
    w64 = wt.double().cpu().permute(3, 2, 0, 1)
    exact = torch.nn.functional.conv2d(x64, w64, padding=1).permute(0, 2, 3, 1)
    assert _rel(got.double().cpu(), exact) < TOL


@pytest.mark.parametrize("shape,heads", [
    ((2, 8, 8, 192), 1), ((1, 16, 16, 384), 2),  # the JAX package's test shapes
    ((3, 8, 8, 2304), 12),                       # the base model's midblock
    ((64, 8, 8, 2304), 12),                      # ... at its largest latent bucket
    ((1, 32, 64, 576), 3),                       # HW = 2048, the largest eligible
    ((2, 5, 13, 96), 2),                         # HW = 65, ch = 16: a ragged last tile
    ((2, 9, 15, 192), 2),                        # ch = 32, HW = 135: three chunks
    ((1, 8, 8, 1200), 1),                        # ch = 400: the CUDA-core path
])
def test_attention_kernel(dev, shape, heads):
    g = torch.Generator().manual_seed(2)
    qkv = _rand(g, shape, dev, 3.0)
    before = attention.fused_pixelnorm_attention.launches
    got = attention.fused_pixelnorm_attention(qkv, heads)
    torch.cuda.synchronize()
    assert attention.fused_pixelnorm_attention.launches == before + 1
    assert got.shape == (*shape[:3], shape[3] // 3)
    assert _rel(got, attention.pixelnorm_attention_reference(qkv, heads)) < TOL
    # and against the same math in float64 on the CPU
    exact = attention.pixelnorm_attention_reference(qkv.double().cpu(), heads)
    assert _rel(got.double().cpu(), exact) < TOL


def test_attention_paths(dev):
    """The C entry point dispatches every width as ``attention_path`` says:
    the widths the models use take the tensor-core kernel, a wide head the
    CUDA-core kernel."""
    for ch in range(1, 513):
        assert attention.library_attention_path(ch) == attention.attention_path(ch), ch
    assert attention.library_attention_path(64) == "tensor_cores"
    assert attention.library_attention_path(400) == "cuda_cores"


def test_attention_rejects_a_misaligned_qkv(dev):
    """The tensor-core kernel copies 16-byte words: a qkv 4 bytes off that
    alignment is refused before launch."""
    buf = torch.zeros(2 * 8 * 8 * 192 + 1, device=dev)
    qkv = buf[1:].view(2, 8, 8, 192)
    assert qkv.is_contiguous() and qkv.data_ptr() % 16 == 4
    before = attention.fused_pixelnorm_attention.launches
    with pytest.raises(ValueError):
        attention.fused_pixelnorm_attention(qkv, 1)
    assert attention.fused_pixelnorm_attention.launches == before


def test_threefry_noise_on_the_card_equals_the_cpu(dev):
    """Not a kernel: the threefry field runs as torch integer and float ops
    on the tensor's device, and the card must draw the CPU's floats bit for
    bit (a float32 sqrt that rounds differently once broke this)."""
    from terrain_diffusion_tpu_torch.ops.noise_field import threefry_noise_batch

    args = (2 ** 63 + 11, [-300, 40], [-1001, 7], 300, 260, 3, 128, 128)
    got = threefry_noise_batch(*args, device=dev)
    assert got.device.type == "cuda"
    assert torch.equal(got.cpu(), threefry_noise_batch(*args, device="cpu"))


def test_wrappers_reject_what_the_kernels_do_not_take(dev):
    x = torch.zeros((1, 8, 8, 4), device=dev)
    w = torch.zeros((3, 3, 4, 4), device=dev)
    with pytest.raises(TypeError):
        fb.conv3x3(x.double(), w.double())
    with pytest.raises(ValueError):
        fb.conv3x3(x.permute(0, 2, 1, 3), w)  # not contiguous
    with pytest.raises(ValueError):
        fb.conv3x3(x, torch.zeros((3, 3, 5, 4), device=dev))
    with pytest.raises(ValueError):
        fb.fused_block(x, w, w, None, torch.zeros((4, 8), device=dev), mode="enc")
    qkv = torch.zeros((1, 8, 8, 48), device=dev)
    with pytest.raises(TypeError):
        attention.fused_pixelnorm_attention(qkv.double(), 2)
    with pytest.raises(ValueError):
        attention.fused_pixelnorm_attention(qkv, 3)  # 16 channels into 3 heads
    with pytest.raises(ValueError):
        attention.fused_pixelnorm_attention(qkv.permute(0, 2, 1, 3), 2)


def _check16(got, plain, exact, half):
    """A 16-bit kernel output against its plain version on the same inputs
    and against the unrounded float64 oracle, beside the plain version's own
    distance to it."""
    assert got.dtype == plain.dtype == half
    assert torch.isfinite(got.float()).all()
    assert _rel(got.float(), plain.float()) < TOL16[half]
    err, err_plain = _rel(got.double().cpu(), exact), _rel(plain.double().cpu(), exact)
    assert err <= 1.25 * err_plain, (err, err_plain)


@pytest.mark.parametrize(
    "n,h,w,cin,cout,mode,with_x2,preup,proj,clip",
    [
        (2, 40, 72, 32, 32, "enc", False, 1, False, 256.0),
        (1, 24, 40, 32, 64, "enc", False, 1, True, 256.0),
        (2, 40, 72, 32, 32, "dec", True, 1, True, 256.0),
        (2, 40, 72, 32, 64, "dec", True, 1, False, 256.0),
        (2, 20, 36, 32, 32, "dec", False, 2, False, 256.0),
        (1, 33, 47, 48, 64, "dec", False, 1, True, None),
        (1, 33, 47, 64, 64, "dec", False, 1, False, 256.0),   # xres is the bf16 x itself
        (1, 12, 20, 256, 256, "dec", False, 2, False, 256.0),
        (1, 21, 37, 192, 64, "dec", False, 1, True, 256.0),
        (2, 19, 27, 33, 40, "enc", False, 1, True, 256.0),     # odd Cin: element copies
        (1, 64, 64, 64, 64, "enc", False, 1, False, 256.0),    # the decoder's widths
        (1, 32, 32, 64, 128, "enc", False, 1, True, 256.0),
    ])
@HALF
def test_fused_block_kernel_16bit(dev, half, n, h, w, cin, cout, mode, with_x2, preup, proj,
                                  clip):
    g = torch.Generator().manual_seed(3)
    cg = 2 * cin if with_x2 else cin
    c_main = cout if (mode == "enc" and proj) else cg
    x = _rand(g, (n, h, w, cin), dev).to(half)
    x2 = _rand(g, (n, h, w, cin), dev).to(half) if with_x2 else None
    w0 = _rand(g, (3, 3, c_main, cout), dev, (9 * c_main) ** -0.5)
    w1 = _rand(g, (3, 3, cout, cout), dev, (9 * cout) ** -0.5)
    wskip = _rand(g, (cg, cout), dev, cg ** -0.5) if proj else None
    c = _rand(g, (n, cout), dev, 0.3) + 1.0
    kw = dict(mode=mode, pixel_norm=(mode == "enc"), res_balance=0.3, clip_act=clip,
              concat_scales=(0.7, 0.3) if with_x2 else None, pre_upsample=preup)
    before = fb.fused_block.launches
    got = fb.fused_block(x, w0, w1, c, wskip, x2, **kw)
    torch.cuda.synchronize()
    assert fb.fused_block.launches == before + 1
    plain = fb.fused_block_reference(x, w0, w1, c, wskip, x2, **kw)
    exact = fb.fused_block_reference(*(t.double().cpu() if t is not None else None
                                       for t in (x, w0, w1, c, wskip, x2)), **kw)
    _check16(got, plain, exact, half)


@pytest.mark.parametrize("n,h,w,cin,cout", [
    (1, 64, 64, 6, 64), (2, 64, 80, 64, 1), (1, 37, 53, 5, 3), (2, 30, 50, 33, 40),
    (1, 21, 35, 6, 64), (2, 19, 27, 33, 1), (1, 13, 50, 6, 40), (1, 9, 17, 256, 8),
    (1, 40, 40, 64, 64), (2, 24, 40, 128, 96)])
@HALF
def test_conv3x3_kernel_16bit(dev, half, n, h, w, cin, cout):
    g = torch.Generator().manual_seed(4)
    x = _rand(g, (n, h, w, cin), dev).to(half)
    wt = _rand(g, (3, 3, cin, cout), dev, (9 * cin) ** -0.5)
    before = fb.conv3x3.launches
    got = fb.conv3x3(x, wt)
    torch.cuda.synchronize()
    assert fb.conv3x3.launches == before + 1
    x64 = x.double().cpu().permute(0, 3, 1, 2)
    w64 = wt.double().cpu().permute(3, 2, 0, 1)
    exact = torch.nn.functional.conv2d(x64, w64, padding=1).permute(0, 2, 3, 1)
    _check16(got, fb.conv3x3_reference(x, wt), exact, half)


@pytest.mark.parametrize("shape,heads", [
    ((2, 8, 8, 192), 1), ((1, 16, 16, 384), 2), ((3, 8, 8, 2304), 12),
    ((64, 8, 8, 2304), 12), ((1, 32, 64, 576), 3), ((2, 5, 13, 96), 2),
    ((2, 9, 15, 192), 2),
    # the CUDA-core kernel's 16-bit form: ch = 8 (HW = 65), ch = 400
    ((2, 5, 13, 120), 5), ((1, 8, 8, 1200), 1)])
@HALF
def test_attention_kernel_16bit(dev, half, shape, heads):
    g = torch.Generator().manual_seed(5)
    qkv = _rand(g, shape, dev, 3.0).to(half)
    before = attention.fused_pixelnorm_attention.launches
    got = attention.fused_pixelnorm_attention(qkv, heads)
    torch.cuda.synchronize()
    assert attention.fused_pixelnorm_attention.launches == before + 1
    exact = attention.pixelnorm_attention_reference(qkv.double().cpu(), heads)
    _check16(got, attention.pixelnorm_attention_reference(qkv, heads), exact, half)


DECODER_WIDTHS = [(cin, cout) for cin in (64, 128, 192, 256, 320, 384, 448)
                  for cout in (64, 128, 192, 256)]


def _core_case(dev, half, n, h, w, cin, cout, seed):
    """Each of the 16-bit conv core's forms on one input, through the C
    entry points, against the same products summed in float32 on the card:
    the 1x1 projection (float32 out), conv0's gain + silu, conv1's residual
    mix + clip with a float32 and a 16-bit residual (16-bit out), and the
    standalone 3x3 conv."""
    from terrain_diffusion_tpu_torch.ops import cuda_lib

    lib = cuda_lib.load()
    code, strm = cuda_lib.DTYPE_CODES[half], cuda_lib.stream(dev)
    g = torch.Generator().manual_seed(seed)
    x = _rand(g, (n, h, w, cin), dev).to(half)
    w1x1 = (_rand(g, (1, cout, cin), dev, cin ** -0.5)).to(half)
    w3 = (_rand(g, (9, cout, cin), dev, (9 * cin) ** -0.5)).to(half)
    c = _rand(g, (n, cout), dev, 0.3) + 1.0
    res = _rand(g, (n, h, w, cout), dev)
    y3 = torch.nn.functional.conv2d(
        x.float().permute(0, 3, 1, 2), w3.float().reshape(3, 3, cout, cin).permute(2, 3, 0, 1),
        padding=1).permute(0, 2, 3, 1)

    proj = torch.empty((n, h, w, cout), device=dev)
    assert lib.tdt_block_proj(x.data_ptr(), 0, w1x1.data_ptr(), proj.data_ptr(), n, h, w, cin,
                              cout, code, strm) == 0
    hmid = torch.empty((n, h, w, cout), device=dev, dtype=half)
    assert lib.tdt_block_conv0(x.data_ptr(), 0, w3.data_ptr(), c.data_ptr(), hmid.data_ptr(),
                               n, h, w, cin, cout, code, strm) == 0
    a, b, norm = fb._residual_coeffs(0.3)
    clip = 0.5 * float(y3.abs().max())  # clips some outputs
    outs = {}
    for name, r in (("f32", res), ("16", res.to(half))):
        outs[name] = torch.empty((n, h, w, cout), device=dev, dtype=half)
        assert lib.tdt_block_conv1(x.data_ptr(), w3.data_ptr(), r.data_ptr(),
                                   int(r.dtype == torch.float32), outs[name].data_ptr(), n, h, w,
                                   cin, cout, a, b, norm, 1, clip, code, strm) == 0
    conv = fb.conv3x3(x, w3.reshape(3, 3, cout, cin).permute(0, 1, 3, 2).contiguous())
    torch.cuda.synchronize()

    assert _rel(proj, x.float() @ w1x1[0].float().t()) < TOL
    want = fb._silu(y3 * c[:, None, None, :])
    assert _rel(hmid.float(), want.to(half).float()) < TOL16[half]
    for name, r in (("f32", res), ("16", res.to(half).float())):
        want = torch.clamp((r * a + y3 * b) / norm, -clip, clip)
        assert _rel(outs[name].float(), want.to(half).float()) < TOL16[half], name
    assert conv.dtype == half and _rel(conv.float(), y3.to(half).float()) < TOL16[half]


@pytest.mark.parametrize("cin,cout", DECODER_WIDTHS)
@HALF
def test_wgmma_core(dev, half, cin, cout):
    """Every decoder block width pair, KS 1 and 3, each epilogue; the map is
    off both tiles (8 x 16 and 16 x 16 pixels)."""
    assert fb.conv16_path(3, cin, cout).startswith("wgmma")
    assert fb.conv16_path(1, cin, cout) == "wgmma_resident"
    _core_case(dev, half, 2, 20, 36, cin, cout, seed=cin + cout)


@pytest.mark.parametrize("n,h,w,cin,cout", [
    (1, 13, 50, 64, 64),     # ragged in both axes, weights resident
    (2, 33, 17, 128, 128),   # two K chunks resident, two Cout slices
    (16, 24, 40, 64, 64),    # batch 16
    (1, 40, 24, 192, 192),   # streamed; 3 Cout slices: the grid rounds to a multiple of 3
    (16, 9, 9, 256, 64),     # streamed, b16 maps smaller than one tile
    (2, 7, 130, 320, 256),   # 5 K chunks, a last column tile of 2 pixels
    (1, 64, 64, 48, 64),     # a K chunk past Cin: TMA fills channels 48..63 with zeros
    (1, 5, 3, 16, 64),       # one pixel tile, 16 channels
])
@HALF
def test_wgmma_core_shapes(dev, half, n, h, w, cin, cout):
    """Maps that are not multiples of the tile, batches 1, 2 and 16, Cout
    slices that do not divide the SMs' persistent grid evenly, and Cin off
    the 64-channel chunk."""
    _core_case(dev, half, n, h, w, cin, cout, seed=7)


def test_conv16_paths(dev):
    """The built library's 16-bit conv chooser equals ``conv16_path``."""
    for ks in (1, 3):
        for cin in range(1, 600):
            for cout in (1, 3, 8, 9, 16, 32, 36, 40, 63, 64, 96, 128, 192, 256, 320, 512):
                assert fb.library_conv16_path(ks, cin, cout) == fb.conv16_path(ks, cin, cout), \
                    (ks, cin, cout)


@HALF
def test_wgmma_core_rejects_a_misaligned_input(dev, half):
    """TMA reads 16-byte aligned rows: a 16-bit input 2 bytes off raises
    ValueError in the wrapper before any launch, in the conv and in the
    block's projection."""
    buf = torch.zeros(1 * 16 * 16 * 64 + 1, device=dev, dtype=half)
    x = buf[1:].view(1, 16, 16, 64)
    assert x.is_contiguous() and x.data_ptr() % 16 == 2
    w = torch.zeros((3, 3, 64, 64), device=dev)
    before = (fb.conv3x3.launches, fb.fused_block.launches)
    with pytest.raises(ValueError, match="aligned"):
        fb.conv3x3(x, w)
    with pytest.raises(ValueError, match="aligned"):
        fb.fused_block(x, w, w, None, torch.zeros((64, 64), device=dev), mode="dec",
                       pixel_norm=False)
    assert (fb.conv3x3.launches, fb.fused_block.launches) == before


HEAD_MAPS = [(1, 37, 53), (2, 19, 130), (16, 9, 21)]  # ragged; batch 1, 2, 16
ALL_TYPES = pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16, torch.float16],
                                    ids=["f32", "bf16", "fp16"])


def _check_any(got, plain, exact, dt):
    """float32: within TOL of the plain version and of the float64 oracle;
    16-bit: ``_check16``."""
    if dt == torch.float32:
        assert got.dtype == torch.float32
        assert _rel(got, plain) < TOL
        assert _rel(got.double().cpu(), exact) < TOL
    else:
        _check16(got, plain, exact, dt)


@pytest.mark.parametrize("n,h,w", HEAD_MAPS)
@pytest.mark.parametrize("cin,cout", [(64, 1), (32, 1), (64, 3), (32, 8), (64, 8)])
@ALL_TYPES
def test_head_kernel(dev, dt, cin, cout, n, h, w):
    """The narrow head against the plain version and the float64 oracle."""
    assert fb.conv16_path(3, cin, cout) == "head"
    g = torch.Generator().manual_seed(8)
    x = _rand(g, (n, h, w, cin), dev).to(dt)
    wt = _rand(g, (3, 3, cin, cout), dev, (9 * cin) ** -0.5)
    before = fb.conv3x3.launches
    got = fb.conv3x3(x, wt)
    torch.cuda.synchronize()
    assert fb.conv3x3.launches == before + 1
    x64 = x.double().cpu().permute(0, 3, 1, 2)
    exact = torch.nn.functional.conv2d(x64, wt.double().cpu().permute(3, 2, 0, 1),
                                       padding=1).permute(0, 2, 3, 1)
    _check_any(got, fb.conv3x3_reference(x, wt), exact, dt)


@pytest.mark.parametrize("n,h,w,cin,cout,mode,proj", [
    (2, 21, 37, 32, 8, "enc", True),    # enc: projection, pixel norm, Cmid = Cout = 8
    (1, 19, 27, 8, 8, "dec", False),    # dec: the residual is x itself
    (16, 9, 17, 32, 3, "dec", True),    # batch 16, Cout 3
    (1, 13, 50, 64, 1, "enc", True),    # Cout 1: whole-word stores
])
@ALL_TYPES
def test_head_kernel_block_forms(dev, dt, n, h, w, cin, cout, mode, proj):
    """The block's convs to at most 8 channels run the head with conv0's
    activation (float32) and gain + silu and conv1's residual mix + clip."""
    g = torch.Generator().manual_seed(9)
    c_main = cout if (mode == "enc" and proj) else cin
    x = _rand(g, (n, h, w, cin), dev).to(dt)
    w0 = _rand(g, (3, 3, c_main, cout), dev, (9 * c_main) ** -0.5)
    w1 = _rand(g, (3, 3, cout, cout), dev, (9 * cout) ** -0.5)
    wskip = _rand(g, (cin, cout), dev, cin ** -0.5) if proj else None
    c = _rand(g, (n, cout), dev, 0.3) + 1.0
    kw = dict(mode=mode, pixel_norm=(mode == "enc"), res_balance=0.3, clip_act=2.0)
    got = fb.fused_block(x, w0, w1, c, wskip, **kw)
    torch.cuda.synchronize()
    exact = fb.fused_block_reference(*(t.double().cpu() if t is not None else None
                                       for t in (x, w0, w1, c, wskip)), **kw)
    _check_any(got, fb.fused_block_reference(x, w0, w1, c, wskip, **kw), exact, dt)


@pytest.mark.parametrize("n,h,w", HEAD_MAPS + [(1, 64, 64)])
@pytest.mark.parametrize("cin,cout", [(6, 64), (6, 32), (8, 64), (4, 16), (6, 40), (6, 96),
                                      (2, 128)])
@HALF
def test_in_conv16_kernel(dev, half, cin, cout, n, h, w):
    """The 16-bit in conv: the decoder's 6 -> 64 and the guide's 6 -> 32,
    Cin 2 to 8, Cout off 64 (one slice clipped by the TMA store) and over 64
    (two slices), on ragged maps at batch 1, 2 and 16."""
    assert fb.conv16_path(3, cin, cout) == "in_conv"
    g = torch.Generator().manual_seed(10)
    x = _rand(g, (n, h, w, cin), dev).to(half)
    wt = _rand(g, (3, 3, cin, cout), dev, (9 * cin) ** -0.5)
    before = fb.conv3x3.launches
    got = fb.conv3x3(x, wt)
    torch.cuda.synchronize()
    assert fb.conv3x3.launches == before + 1
    x64 = x.double().cpu().permute(0, 3, 1, 2)
    exact = torch.nn.functional.conv2d(x64, wt.double().cpu().permute(3, 2, 0, 1),
                                       padding=1).permute(0, 2, 3, 1)
    _check16(got, fb.conv3x3_reference(x, wt), exact, half)


@pytest.mark.parametrize("n,h,w,cin,cout", [(1, 21, 35, 6, 64), (2, 13, 50, 8, 32),
                                            (16, 9, 17, 6, 64)])
@HALF
def test_in_conv16_epilogues(dev, half, n, h, w, cin, cout):
    """conv0's gain + silu and conv1's residual mix + clip (float32 and
    16-bit residual) on the in-conv kernel, through the block's C entry
    points (the 1x1 projection of 6 channels takes the mma.sync core)."""
    assert fb.conv16_path(3, cin, cout) == "in_conv"
    _core_case(dev, half, n, h, w, cin, cout, seed=11)


@HALF
def test_in_conv16_rejects_a_misaligned_input(dev, half):
    """The in conv copies its input as 16-byte words: a 16-bit input 2
    bytes off raises ValueError in the wrapper before any launch."""
    buf = torch.zeros(1 * 16 * 16 * 6 + 1, device=dev, dtype=half)
    x = buf[1:].view(1, 16, 16, 6)
    assert x.is_contiguous() and x.data_ptr() % 16 == 2
    before = fb.conv3x3.launches
    with pytest.raises(ValueError, match="aligned"):
        fb.conv3x3(x, torch.zeros((3, 3, 6, 64), device=dev))
    assert fb.conv3x3.launches == before


def test_kernels_route_by_dtype(dev):
    """float32 goes to the float32 kernels and bf16 / fp16 to the 16-bit
    ones, each counted under its type and answering in its input's type; a
    mixed pair and float64 raise TypeError before any launch; a 16-bit qkv
    at a width off the tensor-core path (the "wide head 8x8 1x400" shape)
    runs the CUDA-core kernel's 16-bit form and matches the plain version."""
    from terrain_diffusion_tpu_torch.ops import cuda_lib

    g = torch.Generator().manual_seed(6)
    x = _rand(g, (1, 16, 16, 32), dev)
    w = _rand(g, (3, 3, 32, 32), dev, (9 * 32) ** -0.5)
    qkv = _rand(g, (1, 8, 8, 192), dev)
    cuda_lib.reset_launch_counts()
    for dt in (torch.float32, torch.bfloat16, torch.float16):
        assert fb.conv3x3(x.to(dt), w).dtype == dt
        assert fb.fused_block(x.to(dt), w, w, None, mode="dec", pixel_norm=False).dtype == dt
        assert attention.fused_pixelnorm_attention(qkv.to(dt), 1).dtype == dt
    for fn in (fb.conv3x3, fb.fused_block, attention.fused_pixelnorm_attention):
        assert fn.launches == 3
        assert fn.launches_by_dtype == {torch.float32: 1, torch.bfloat16: 1, torch.float16: 1}
    with pytest.raises(TypeError):  # mixed pair: x2 must have x's type
        fb.fused_block(x.bfloat16(), _rand(g, (3, 3, 64, 32), dev), w, None, x2=x,
                       mode="dec", pixel_norm=False, concat_scales=(0.7, 0.3))
    with pytest.raises(TypeError):
        fb.conv3x3(x.double(), w)
    with pytest.raises(TypeError):
        fb.fused_block(x.double(), w, w, None, mode="dec", pixel_norm=False)
    wide = _rand(g, (1, 8, 8, 1200), dev, 3.0)
    for half in (torch.bfloat16, torch.float16):  # ch = 400: the CUDA-core kernel
        got = attention.fused_pixelnorm_attention(wide.to(half), 1)
        want = attention.pixelnorm_attention_reference(wide.to(half), 1)
        assert got.dtype == want.dtype == half
        assert _rel(got.float(), want.float()) < TOL16[half]
    assert (fb.conv3x3.launches, fb.fused_block.launches) == (3, 3)
    assert attention.fused_pixelnorm_attention.launches == 5


def test_registered_operators_on_the_card(dev):
    """Each kernel's operator (tdt::fused_block, tdt::conv3x3,
    tdt::pixelnorm_attention): through the dispatcher, its CUDA
    implementation equals the launch code called directly and the wrapper,
    bit for bit, each call counting one launch; its Meta implementation
    gives the CUDA output's shape and type; and a CPU tensor runs the plain
    version."""
    g = torch.Generator().manual_seed(13)
    x = _rand(g, (2, 24, 40, 32), dev)
    x2 = _rand(g, (2, 24, 40, 32), dev)
    w0 = _rand(g, (3, 3, 64, 32), dev, (9 * 64) ** -0.5)
    w1 = _rand(g, (3, 3, 32, 32), dev, (9 * 32) ** -0.5)
    wskip = _rand(g, (64, 32), dev, 64 ** -0.5)
    wc = _rand(g, (3, 3, 32, 1), dev, (9 * 32) ** -0.5)
    qkv = _rand(g, (2, 8, 8, 192), dev, 3.0)
    block = ("dec", False, 0.3, 256.0, [0.7, 0.3], 1)
    cases = [  # (wrapper call, operator, its arguments, the launch code, counter)
        (lambda: fb.fused_block(x, w0, w1, None, wskip, x2, mode="dec", pixel_norm=False,
                                concat_scales=(0.7, 0.3)),
         torch.ops.tdt.fused_block.default, (x, w0, w1, None, wskip, x2, *block),
         fb._fused_block_cuda, fb.fused_block),
        (lambda: fb.conv3x3(x, wc), torch.ops.tdt.conv3x3.default, (x, wc), fb._conv3x3_cuda,
         fb.conv3x3),
        (lambda: attention.fused_pixelnorm_attention(qkv, 2),
         torch.ops.tdt.pixelnorm_attention.default, (qkv, 2, 1e-4), attention._attention_cuda,
         attention.fused_pixelnorm_attention),
    ]
    for call, op, args, launch, counter in cases:
        before = counter.launches
        got, direct, wrapped = op(*args), launch(*args), call()
        torch.cuda.synchronize()
        assert counter.launches == before + 3
        assert torch.equal(got, direct) and torch.equal(got, wrapped)
        meta = op(*[a.to("meta") if isinstance(a, torch.Tensor) else a for a in args])
        assert meta.shape == got.shape and meta.dtype == got.dtype
        plain = op(*[a.cpu() if isinstance(a, torch.Tensor) else a for a in args])
        assert counter.launches == before + 3  # the CPU runs the plain version
        assert _rel(got.cpu(), plain) < TOL


def test_wrappers_refuse_autograd_on_the_card(dev):
    """A CUDA input autograd records through raises instead of coming back
    without grad_fn; under no_grad the same call launches."""
    g = torch.Generator().manual_seed(3)
    x, w = _rand(g, (1, 16, 16, 8), dev), _rand(g, (3, 3, 8, 8), dev, 0.1)
    qkv = _rand(g, (1, 8, 8, 48), dev)
    for call, inp in ((lambda a: fb.conv3x3(a, w), x),
                      (lambda a: fb.fused_block(a, w, w, None, mode="dec"), x),
                      (lambda a: attention.fused_pixelnorm_attention(a, 2), qkv)):
        with pytest.raises(RuntimeError, match="no backward"):
            call(inp.clone().requires_grad_())
        with torch.no_grad():
            assert torch.isfinite(call(inp.clone().requires_grad_())).all()


def test_training_forward_on_the_card_takes_the_plain_path(dev):
    """A 128x128 U-Net: a training forward launches no kernel and its loss
    and gradients match the CPU's; the same model under no_grad in eval
    launches every top-level block and both convs."""
    from terrain_diffusion_tpu_torch.nn.edm_unet import EDMUnet2D, EDMUnetConfig
    from terrain_diffusion_tpu_torch.ops import cuda_lib

    cfg = EDMUnetConfig(image_size=128, in_channels=3, out_channels=2, model_channels=16,
                        model_channel_mults=(1, 2), layers_per_block=1, fourier_scale="pos",
                        noise_emb_dims=16, logvar_channels=8)
    cpu = EDMUnet2D(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        cpu.out_gain.fill_(1.0)
        for name, p in cpu.named_parameters():
            if name.endswith("emb_gain"):
                p.fill_(0.4)
    card = EDMUnet2D(cfg, device=dev, generator=torch.Generator())
    card.load_state_dict(cpu.state_dict())
    g = torch.Generator().manual_seed(1)
    x, nl = torch.randn((2, 128, 128, 3), generator=g), torch.tensor([0.3, 1.2])
    grads = []
    for m, d in ((card, dev), (cpu, "cpu")):
        cuda_lib.reset_launch_counts()
        y, lv = m(x.to(d), nl.to(d), return_logvar=True, training=True)
        (y.square().mean() + lv.mean()).backward()
        grads.append({k: p.grad.cpu() for k, p in m.named_parameters()})
        if m is card:
            assert fb.fused_block.launches == fb.conv3x3.launches == 0
    for k, want in grads[1].items():
        assert _rel(grads[0][k], want) < TOL, k
    cuda_lib.reset_launch_counts()
    with torch.no_grad():
        card.eval()(x.to(dev), nl.to(dev))
    top = sum(1 for name, kind, *_ in card.enc_plan + card.dec_plan
              if kind == "block" and name.startswith("128x128_"))
    assert (fb.fused_block.launches, fb.conv3x3.launches) == (top, 2)


def test_autoencoder_validation_forward_on_the_card(dev, monkeypatch):
    """The autoencoder trainer's validation loss (``autoencoder_loss`` under
    no_grad, eval mode) and a VAE round trip at 128x128 on the card: with
    the kernels (every block of at least 128 x 128 pixels and the in conv
    launch), then with the wrappers raising and the cutover out of reach
    (the plain path), within TOL."""
    from terrain_diffusion_tpu_torch.nn import edm_unet, layers
    from terrain_diffusion_tpu_torch.nn.edm_autoencoder import (EDMAutoencoder,
                                                               EDMAutoencoderConfig)
    from terrain_diffusion_tpu_torch.ops import cuda_lib
    from terrain_diffusion_tpu_torch.ops.noise_field import key_from_seed
    from terrain_diffusion_tpu_torch.training.diffusion_core import autoencoder_loss

    cfg = EDMAutoencoderConfig(image_size=128, in_channels=1, latent_channels=4,
                               out_channels=1, model_channels=32, model_channel_mults=(1, 2),
                               layers_per_block=1, attn_resolutions=(),
                               midblock_attention=False)
    ae = EDMAutoencoder(cfg, device=dev, generator=torch.Generator().manual_seed(0)).eval()
    x = torch.randn((2, 128, 128, 1), generator=torch.Generator().manual_seed(1)).to(dev)

    def run():
        with torch.no_grad():
            loss, aux = autoencoder_loss(ae, {"image": x}, key_from_seed(3))
            means, _ = ae.preencode(x)
            return [loss, aux["mae"], aux["kl"], means, ae.decode(means)]

    cuda_lib.reset_launch_counts()
    got = run()
    n_enc = sum(1 for name, kind, *_ in ae.encoder.enc_plan
                if kind == "block" and name.startswith("128x128_"))
    n_dec = sum(1 for name, *_ in ae.decoder_plan if name.startswith("128x128_") or name == "up0")
    assert (fb.fused_block.launches, fb.conv3x3.launches) == (2 * (n_enc + n_dec), 2)

    def boom(*a, **k):
        raise AssertionError("a kernel wrapper was called")

    monkeypatch.setattr(layers, "fused_block", boom)
    monkeypatch.setattr(edm_unet, "conv3x3", boom)
    monkeypatch.setattr(layers, "FUSED_MIN_PIXELS", 1 << 62)
    monkeypatch.setattr(edm_unet, "FUSED_MIN_PIXELS", 1 << 62)
    want = run()
    for a, b in zip(got, want):
        assert _rel(a.cpu(), b.cpu()) < TOL


# The VAE (autoencoder_x8.cfg): blocks without an embedding (c = None) at the
# enc and dec widths the decoder U-Net never sends - a 256 -> 128 projection,
# 128- and 256-channel pre-upsamples, 128 -> 256 and 128 -> 64 projections -
# on ragged maps, and the encoder's in conv from 2 channels (1 + the ones
# channel) to 64.
VAE_BLOCKS = [  # (n, h, w, cin, cout, mode, pre_upsample, projection)
    (2, 40, 72, 64, 64, "enc", 1, False),
    (2, 40, 72, 128, 128, "enc", 1, False),
    (1, 33, 47, 128, 256, "enc", 1, True),
    (1, 33, 47, 256, 256, "enc", 1, False),
    (1, 33, 47, 256, 256, "dec", 1, False),
    (1, 20, 36, 256, 256, "dec", 2, False),
    (2, 21, 37, 256, 128, "dec", 1, True),
    (2, 40, 72, 128, 128, "dec", 1, False),
    (1, 20, 36, 128, 128, "dec", 2, False),
    (2, 21, 37, 128, 64, "dec", 1, True),
    (2, 40, 72, 64, 64, "dec", 1, False),
]
VAE_TYPES = pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])


@pytest.mark.parametrize("n,h,w,cin,cout,mode,preup,proj", VAE_BLOCKS)
@VAE_TYPES
def test_vae_block_shapes(dev, dt, n, h, w, cin, cout, mode, preup, proj):
    g = torch.Generator().manual_seed(12)
    c_main = cout if (mode == "enc" and proj) else cin
    x = _rand(g, (n, h, w, cin), dev).to(dt)
    w0 = _rand(g, (3, 3, c_main, cout), dev, (9 * c_main) ** -0.5)
    w1 = _rand(g, (3, 3, cout, cout), dev, (9 * cout) ** -0.5)
    wskip = _rand(g, (cin, cout), dev, cin ** -0.5) if proj else None
    kw = dict(mode=mode, pixel_norm=(mode == "enc"), res_balance=0.3, clip_act=256.0,
              pre_upsample=preup)
    before = fb.fused_block.launches
    got = fb.fused_block(x, w0, w1, None, wskip, **kw)
    torch.cuda.synchronize()
    assert fb.fused_block.launches == before + 1
    assert got.shape == (n, h * preup, w * preup, cout)
    exact = fb.fused_block_reference(*(t.double().cpu() if t is not None else None
                                       for t in (x, w0, w1, None, wskip)), **kw)
    _check_any(got, fb.fused_block_reference(x, w0, w1, None, wskip, **kw), exact, dt)


@pytest.mark.parametrize("n,h,w", [(2, 64, 64), (1, 37, 53), (16, 9, 21)])
@VAE_TYPES
def test_vae_in_conv(dev, dt, n, h, w):
    g = torch.Generator().manual_seed(13)
    x = _rand(g, (n, h, w, 2), dev).to(dt)
    wt = _rand(g, (3, 3, 2, 64), dev, 18 ** -0.5)
    if dt != torch.float32:
        assert fb.conv16_path(3, 2, 64) == "in_conv"
    before = fb.conv3x3.launches
    got = fb.conv3x3(x, wt)
    torch.cuda.synchronize()
    assert fb.conv3x3.launches == before + 1
    exact = torch.nn.functional.conv2d(x.double().cpu().permute(0, 3, 1, 2),
                                       wt.double().cpu().permute(3, 2, 0, 1),
                                       padding=1).permute(0, 2, 3, 1)
    _check_any(got, fb.conv3x3_reference(x, wt), exact, dt)


def test_explorer_detail_raw_through_the_kernels(dev, monkeypatch):
    """The explorer's /api/detail_raw on a world of small seeded models with
    decoder tiles of 512 (the decoder's blocks, in conv and head on the
    kernels, the base midblock on the attention kernel) against the same
    world with every block, conv and attention on the plain path, on the
    card: the decoder stage's residual over the region within 1e-4 relative,
    the int16 elevation on the wire within 1 m (floor can flip at an integer
    boundary), the temperature within 1e-4 relative."""
    import copy
    import io

    from terrain_diffusion_tpu_torch.nn import edm_unet, layers
    from terrain_diffusion_tpu_torch.nn.edm_unet import EDMUnet2D, EDMUnetConfig
    from terrain_diffusion_tpu_torch.ops import cuda_lib
    from terrain_diffusion_tpu_torch.pipeline.world import WorldPipeline
    from terrain_diffusion_tpu_torch.serving.explorer import server as explorer

    common = dict(layers_per_block=1, attn_resolutions=(), concat_balance=0.5,
                  fourier_scale="pos", noise_emb_dims=16, logvar_channels=8)
    cfgs = [dict(image_size=16, in_channels=11, out_channels=6, model_channels=16,
                 model_channel_mults=(1,), midblock_attention=False,
                 conditional_inputs=tuple(("float", 8, 0.2) for _ in range(5)), **common),
            dict(image_size=64, in_channels=5, out_channels=5, model_channels=16,
                 model_channel_mults=(1, 2), midblock_attention=True,
                 conditional_inputs=(("tensor", 58, 1.0),),
                 block_kwargs={"channels_per_head": 16, "attention_impl": "pallas"}, **common),
            dict(image_size=512, in_channels=5, out_channels=1, model_channels=16,
                 model_channel_mults=(1, 2), midblock_attention=False, conditional_inputs=(),
                 **common)]
    g = torch.Generator().manual_seed(5)
    models = [EDMUnet2D(EDMUnetConfig(**c), device="cpu", generator=g) for c in cfgs]
    with torch.no_grad():
        for m in models:
            for name, p in m.named_parameters():
                if name.endswith("emb_gain"):
                    p.fill_(0.3)
                elif name == "out_gain":
                    p.fill_(1.0)

    def detail_raw(world):
        explorer.configure(pipeline=world)
        environ = {"REQUEST_METHOD": "GET", "PATH_INFO": "/api/detail_raw",
                   "QUERY_STRING": "ci=0&cj=0&detail_size=512&pan_i=37&pan_j=-11",
                   "wsgi.input": io.BytesIO(b""), "CONTENT_LENGTH": "0"}
        out = {}
        body = b"".join(explorer.app.wsgi(environ, lambda s, h: out.update(s=s, h=dict(h))))
        assert out["s"].startswith("200") and out["h"]["X-Height"] == "512"
        n = 512 * 512
        residual = world.residual[:, 37 - 300:37 + 300, -11 - 300:-11 + 300]
        return (np.frombuffer(body[:2 * n], "<i2").astype(np.int32),
                np.frombuffer(body[2 * n:], "<f4"), residual)

    cuda_lib.reset_launch_counts()
    kern = WorldPipeline(seed=11, device=dev).set_models(*copy.deepcopy(models)).bind()
    got = detail_raw(kern)
    assert fb.fused_block.launches > 0 and fb.conv3x3.launches > 0
    assert attention.fused_pixelnorm_attention.launches > 0
    cuda_lib.reset_launch_counts()
    monkeypatch.setattr(layers, "FUSED_MIN_PIXELS", 1 << 40)
    monkeypatch.setattr(edm_unet, "FUSED_MIN_PIXELS", 1 << 40)
    plain_models = copy.deepcopy(models)
    for m in plain_models[1].modules():
        if isinstance(m, layers.UNetBlock):
            m.attention_impl = "xla"
    plain = WorldPipeline(seed=11, device=dev).set_models(*plain_models).bind()
    want = detail_raw(plain)
    assert fb.fused_block.launches == fb.conv3x3.launches == 0
    assert attention.fused_pixelnorm_attention.launches == 0
    assert _rel(torch.from_numpy(got[2]), torch.from_numpy(want[2])) < TOL
    assert np.abs(got[0] - want[0]).max() <= 1 and got[0].std() > 0
    assert _rel(torch.from_numpy(got[1].copy()), torch.from_numpy(want[1].copy())) < TOL
    explorer.configure()
