"""The one place where NHWC activations meet PyTorch's NCHW convolution.

The port keeps activations NHWC (as the JAX package does) and stores conv
weights OIHW (as the reference checkpoints do).  ``x.permute(0, 3, 1, 2)``
of a contiguous NHWC tensor is an NCHW view in channels-last memory order,
so the permutes cost no copy and cuDNN runs its channels-last kernels.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def _widened(x: torch.Tensor) -> bool:
    """A 16-bit CPU tensor: its convs and matmuls sum in float64 and round
    their output once to its type.  PyTorch's own 16-bit CPU conv takes
    oneDNN's bf16 path where the CPU has bf16 instructions and another path
    where it has not, and its float32 conv too sums in another order through
    oneDNN than without it; a last-bit difference then flips a 16-bit
    rounding, so the result would depend on the machine.  Float64 takes one
    path everywhere, and its sums round to the same 16-bit values.  On the
    card cuDNN and cuBLAS run them as given."""
    return x.device.type == "cpu" and x.dtype in (torch.bfloat16, torch.float16)


def matmul_16(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``torch.matmul(x, w)``, summed in float64 for a 16-bit CPU `x`."""
    if _widened(x):
        return torch.matmul(x.double(), w.double()).to(x.dtype)
    return torch.matmul(x, w)


def conv2d_nhwc(x: torch.Tensor, w_oihw: torch.Tensor, padding: int = 0,
                groups: int = 1, stride: int = 1) -> torch.Tensor:
    """conv2d of NHWC `x` with an OIHW weight; returns NHWC (see
    ``_widened`` for a 16-bit CPU `x`)."""
    wide = _widened(x)
    y = F.conv2d(x.permute(0, 3, 1, 2).double() if wide else x.permute(0, 3, 1, 2),
                 w_oihw.double() if wide else w_oihw, padding=padding, groups=groups,
                 stride=stride)
    return (y.to(x.dtype) if wide else y).permute(0, 2, 3, 1)


def conv_transpose2d_nhwc(x: torch.Tensor, w_iohw: torch.Tensor,
                          stride: int) -> torch.Tensor:
    """Transposed conv of NHWC `x` with an (in, out, kh, kw) weight, no
    padding; returns NHWC."""
    wide = _widened(x)
    y = F.conv_transpose2d(x.permute(0, 3, 1, 2).double() if wide else x.permute(0, 3, 1, 2),
                           w_iohw.double() if wide else w_iohw, stride=stride)
    return (y.to(x.dtype) if wide else y).permute(0, 2, 3, 1)


def hwio_to_oihw(w: torch.Tensor) -> torch.Tensor:
    return w.permute(3, 2, 0, 1)


def oihw_to_hwio(w: torch.Tensor) -> torch.Tensor:
    return w.permute(2, 3, 1, 0)
