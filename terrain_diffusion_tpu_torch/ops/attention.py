"""The U-Net's pixel-norm attention core: its hand-written CUDA kernel, the
wrapper and the plain PyTorch version.

Counterpart of ``terrain_diffusion_tpu.ops.pallas_attention``:

- ``fused_pixelnorm_attention(qkv, num_heads)`` calls the operator
  ``tdt::pixelnorm_attention`` (``cuda_lib.register_op``), which launches
  ``csrc/attention.cu`` (the counterpart of the Pallas kernel
  ``fused_pixelnorm_attention``) for a CUDA tensor, and computes
  ``pixelnorm_attention_reference`` for a CPU tensor.  It counts its
  launches in ``fused_pixelnorm_attention.launches``.  On any device it
  raises RuntimeError where autograd would record through qkv: the kernel
  defines no backward (``cuda_lib.refuse_autograd``).
- ``attention_path(ch)`` says which of the source's two kernels a head of
  ``ch`` channels runs: the 3xTF32 tensor-core kernel for 16, 32 and 64
  channels, the CUDA-core kernel for any other width.  The C entry point
  dispatches by its own copy of the rule, which ``library_attention_path``
  reads from the built library; the card tests hold the two equal.
- ``pixelnorm_attention_reference`` is the explicit float32 einsum + softmax
  the U-Net block runs when the kernel is not asked for.
- ``attention_eligible`` is the JAX package's routing rule for the kernel,
  as it is.  It mirrors the Pallas kernel's VMEM limit, which the CUDA
  kernel (online softmax over key chunks) does not share; an ineligible
  shape runs the plain version on the card too, by design, as in JAX.  The
  base model's midblock (8x8, 12 heads) is eligible at every latent bucket.

qkv is (N, H, W, 3C) with channels laid out (head, channel, qkv), the qkv
index fastest; the result is (N, H, W, C), before the output projection, in
qkv's type.  A bfloat16 or float16 qkv (the qkv conv's output in a 16-bit
U-Net) goes to the 16-bit form of the kernel its width takes, which widens
each value to float32 as it stages it, runs the pixel norm, softmax and
both products as for float32, and rounds the output once: the Pallas
kernel's rounding points (``_attn_kernel`` widens ``qkv``, writes
``qkv.dtype``).  Bound, as in float32, by its bytes at the midblock's
shapes, now 2 bytes a value.  Every width takes 16 bits, as in JAX; any
other type raises TypeError.
"""
from __future__ import annotations

import math

import torch

from terrain_diffusion_tpu_torch.ops.cuda_lib import (DTYPE_CODES, check_input, check_rc,
                                                      count_launch, counted, kernel_dtype,
                                                      load, refuse_autograd, register_op,
                                                      stream)

TENSOR_CORE_CHANNELS = (16, 32, 64)  # csrc/attention.cu's pixelnorm_attention_tc<CH>


def attention_path(ch: int) -> str:
    """The kernel a head of ``ch`` channels runs on the card: "tensor_cores"
    (3xTF32 ``mma.sync``) or "cuda_cores" (float32 FMAs); the C entry point
    dispatches by the same rule."""
    return "tensor_cores" if ch in TENSOR_CORE_CHANNELS else "cuda_cores"


def library_attention_path(ch: int) -> str:
    """The kernel the built library's C entry point dispatches a head of
    ``ch`` channels to (``tdt_attention_path``); builds the library."""
    return "tensor_cores" if load().tdt_attention_path(ch) else "cuda_cores"


def attention_eligible(qkv: torch.Tensor, num_heads: int) -> bool:
    """The JAX kernel's feasibility rule: heads divide the channels, at
    most 2048 pixels, and a (HW, HW) f32 logit working set within 64 MiB."""
    n, h, w, c3 = qkv.shape
    c = c3 // 3
    if num_heads <= 0 or c % num_heads:
        return False
    hw = h * w
    ch = c // num_heads
    vmem = 3 * hw * hw * 4 + 4 * ch * hw * 4
    return hw <= 2048 and vmem <= 64 * 1024 * 1024


def pixelnorm_attention_reference(qkv: torch.Tensor, num_heads: int,
                                  eps: float = 1e-4, round_normed: bool = False) -> torch.Tensor:
    """Plain version: pixel-norm q, k, v over each head's channels, softmax
    of q.k / sqrt(ch) over the keys, weighted sum of v; in float32, or in
    float64 for a float64 input (the kernel's exact oracle in the tests).  A
    16-bit qkv is widened to float32 and the output rounded to its type;
    ``round_normed`` also rounds the pixel-normed q, k, v to it, as the JAX
    package's XLA formulation (``mp.normalize`` in qkv's type) does."""
    n, h, w, c3 = qkv.shape
    c = c3 // 3
    ch = c // num_heads
    y = qkv.to(torch.promote_types(qkv.dtype, torch.float32))
    y = y.reshape(n, h * w, num_heads, ch, 3).permute(0, 2, 3, 4, 1)  # (N, heads, ch, 3, HW)
    norm = torch.sqrt(torch.sum(y * y, dim=2, keepdim=True))
    y = y / (eps + norm * math.sqrt(1.0 / ch))  # mp.normalize over ch
    if round_normed:
        y = y.to(qkv.dtype).to(y.dtype)
    q, k, v = (y[:, :, :, i] for i in range(3))
    logits = torch.einsum("nhcq,nhck->nhqk", q, k / math.sqrt(ch))
    wts = torch.softmax(logits, dim=3)
    out = torch.einsum("nhqk,nhck->nhcq", wts, v)
    return out.permute(0, 3, 1, 2).reshape(n, h, w, c).to(qkv.dtype)


@counted
def fused_pixelnorm_attention(qkv: torch.Tensor, num_heads: int,
                              eps: float = 1e-4) -> torch.Tensor:
    """(N, H, W, 3C) float32, bfloat16 or float16 qkv -> (N, H, W, C) attention
    output in qkv's type."""
    refuse_autograd("fused_pixelnorm_attention", qkv)
    return ATTENTION_OP(qkv, int(num_heads), float(eps))


def _attention_cuda(qkv: torch.Tensor, num_heads: int, eps: float) -> torch.Tensor:
    """``tdt::pixelnorm_attention`` on the card: checks and one launch."""
    dt = kernel_dtype("qkv", qkv)
    check_input("qkv", qkv, qkv.device, 4, dt)
    n, h, w, c3 = qkv.shape
    if c3 % 3 or num_heads <= 0 or (c3 // 3) % num_heads:
        raise ValueError(f"qkv shape {tuple(qkv.shape)} does not split into "
                         f"3 x {num_heads} heads")
    if qkv.data_ptr() % 16:
        raise ValueError("qkv must be 16-byte aligned: the kernel copies 16-byte words")
    c = c3 // 3
    ch = c // num_heads
    out = torch.empty((n, h, w, c), device=qkv.device, dtype=dt)
    check_rc(load().tdt_pixelnorm_attention(qkv.data_ptr(), out.data_ptr(), n, h * w, num_heads,
                                            ch, float(eps), DTYPE_CODES[dt], stream(qkv.device)),
             "fused_pixelnorm_attention")
    count_launch(fused_pixelnorm_attention, dt)
    return out


ATTENTION_OP = register_op(
    "pixelnorm_attention(Tensor qkv, int num_heads, float eps) -> Tensor",
    cuda=_attention_cuda, cpu=pixelnorm_attention_reference,
    meta=lambda qkv, num_heads, eps: qkv.new_empty((*qkv.shape[:3], qkv.shape[3] // 3)))
