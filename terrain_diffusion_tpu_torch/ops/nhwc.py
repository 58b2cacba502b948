"""The one place where NHWC activations meet PyTorch's NCHW convolution.

The port keeps activations NHWC (as the JAX package does) and stores conv
weights OIHW (as the reference checkpoints do).  ``x.permute(0, 3, 1, 2)``
of a contiguous NHWC tensor is an NCHW view in channels-last memory order,
so the permutes cost no copy and cuDNN runs its channels-last kernels.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def conv2d_nhwc(x: torch.Tensor, w_oihw: torch.Tensor, padding: int = 0,
                groups: int = 1, stride: int = 1) -> torch.Tensor:
    """conv2d of NHWC `x` with an OIHW weight; returns NHWC."""
    y = F.conv2d(x.permute(0, 3, 1, 2), w_oihw, padding=padding, groups=groups,
                 stride=stride)
    return y.permute(0, 2, 3, 1)


def conv_transpose2d_nhwc(x: torch.Tensor, w_iohw: torch.Tensor,
                          stride: int) -> torch.Tensor:
    """Transposed conv of NHWC `x` with an (in, out, kh, kw) weight, no
    padding; returns NHWC."""
    y = F.conv_transpose2d(x.permute(0, 3, 1, 2), w_iohw, stride=stride)
    return y.permute(0, 2, 3, 1)


def hwio_to_oihw(w: torch.Tensor) -> torch.Tensor:
    return w.permute(3, 2, 0, 1)


def oihw_to_hwio(w: torch.Tensor) -> torch.Tensor:
    return w.permute(2, 3, 1, 0)
