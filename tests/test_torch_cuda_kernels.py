"""The hand-written CUDA kernels against their plain PyTorch versions, on
the card.  Marked `cuda`: skipped where torch sees no CUDA device.

This file imports no JAX, so on a machine without it run it without the
repository conftest:
    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_kernels.py

Bar: max|diff| / max|ref| < 1e-4 - float32 on both sides (TF32 off), with
another summation order.  Shapes are small and deliberately ragged (maps
that are not a multiple of the tile, channel counts off the tile width).
"""
import numpy as np
import pytest
import torch

from terrain_diffusion_tpu_torch import use_full_f32
from terrain_diffusion_tpu_torch.ops import fused_block as fb

pytestmark = pytest.mark.cuda
TOL = 1e-4


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


@pytest.mark.parametrize("n,h,w,cin,cout", [
    (1, 64, 64, 6, 64), (2, 64, 80, 64, 1), (1, 37, 53, 5, 3), (2, 30, 50, 33, 40)])
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
