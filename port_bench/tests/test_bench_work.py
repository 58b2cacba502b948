"""The frozen work counts against hand counts."""
import numpy as np

from harness import work


def test_block_work_by_hand():
    # a decoder block at 8x8, b2: 96 -> 64 channels with a 32-channel skip,
    # float32: conv0 96->64, conv1 64->64, projection 96->64
    px = 2 * 8 * 8
    flops, nbytes = work.block_work(px, 96, 64, 64, "dec", 4, 2, cx=64, cskip=32)
    assert flops == 2 * 9 * px * (96 * 64 + 64 * 64) + 2 * px * 96 * 64
    weights = 9 * (96 * 64 + 64 * 64) + 96 * 64
    assert nbytes == (px * 64 + px * 32 + px * 64 + weights) * 4 + 2 * 64 * 4


def test_unet_forward_flops_by_hand():
    cfg = {"image_size": 16, "in_channels": 3, "out_channels": 2, "model_channels": 8,
           "model_channel_mults": [1, 2], "layers_per_block": 1, "attn_resolutions": [8],
           "midblock_attention": False, "conditional_inputs": [], "fourier_scale": "pos",
           "block_kwargs": {"channels_per_head": 8}}
    n, h = 2, 16
    c3 = lambda cin, cout, res: 2 * 9 * cin * cout * n * res * res  # noqa: E731
    c1 = lambda cin, cout, res: 2 * cin * cout * n * res * res  # noqa: E731
    att = lambda c, res: c1(c, 3 * c, res) + c1(c, c, res) + 4 * n * (res * res) ** 2 * c  # noqa
    want = (c3(4, 8, 16)                                          # in conv (3 + ones)
            + c3(8, 8, 16) * 2                                    # enc 16 block0
            + c3(8, 8, 8) * 2                                     # enc 8 down
            + c3(16, 16, 8) * 2 + c1(8, 16, 8) + att(16, 8)       # enc 8 block0 (attention)
            + c3(16, 16, 8) * 2                                   # dec in0
            + c3(16, 16, 8) * 2                                   # dec in1
            + c3(32, 16, 8) + c3(16, 16, 8) + c1(32, 16, 8) + att(16, 8)   # dec 8 block0
            + c3(24, 16, 8) + c3(16, 16, 8) + c1(24, 16, 8) + att(16, 8)   # dec 8 block1
            + c3(16, 16, 16) * 2                                  # dec 16 up
            + c3(24, 8, 16) + c3(8, 8, 16) + c1(24, 8, 16)        # dec 16 block0
            + c3(16, 8, 16) + c3(8, 8, 16) + c1(16, 8, 16)        # dec 16 block1
            + c3(8, 2, 16))                                       # out conv
    assert work.unet_forward_flops(cfg, n, h) == want
    assert np.isclose(sum(f for f, _ in work.forward_ops(cfg, n, h, "fp32")), want)


def test_roofline_time_takes_the_larger_bound_per_op():
    cfg = {"image_size": 8, "in_channels": 1, "out_channels": 1, "model_channels": 64,
           "model_channel_mults": [1], "layers_per_block": 1, "attn_resolutions": [],
           "midblock_attention": False, "conditional_inputs": [], "fourier_scale": "pos"}
    ops = work.forward_ops(cfg, 1, 8, "bf16")
    t = work.roofline_s(cfg, 1, 8, "bf16")
    assert np.isclose(t, sum(max(f / 989e12, b / 3.35e12) for f, b in ops))
    assert work.PEAK_FLOPS["fp32"] == 495e12 / 3
