"""PyTorch + CUDA port of terrain_diffusion_tpu: its serving, training,
evaluation and data-preparation paths, module for module.

The JAX package (``terrain_diffusion_tpu``) stays the reference this
package is held against; this package imports neither it nor JAX.  Each
module names its JAX counterpart by path.
"""
import torch


def use_full_f32() -> None:
    """Run float32 convolutions and matmuls at full float32 precision.

    cuDNN's default of TF32 for float32 convolutions keeps about three
    decimal digits and would break parity with the JAX f32 path, which runs
    at Precision.HIGHEST.  This is the one place the port sets precision.
    """
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
