"""Build, load and launch helpers shared by the hand-written CUDA kernels.

Every ``csrc/*.cu`` source is compiled with nvcc (one process per source,
run in parallel) and linked into one shared library with a plain C
interface, at first use, into ``_build/`` beside this package (named by a
hash of the sources, headers and flags), and loaded with ctypes.
Nothing here runs at import: the CPU tests import every module, and the
CPU has no nvcc.

Each kernel wrapper is registered with ``counted``: it gets a plain integer
``launches`` attribute and a ``launches_by_dtype`` dict (float32 and the
16-bit forms apart) that ``count_launch`` raises by one where the wrapper
launches its kernel, and ``reset_launch_counts`` zeroes all of them.

The kernels define no backward, as the Pallas kernels define no VJP: every
wrapper calls ``refuse_autograd`` first, on any device, so that a tensor
without ``grad_fn`` is never returned where autograd records; the models
route such forwards to the plain versions by ``autograd_live``.

Each kernel is a PyTorch operator of the ``tdt`` namespace
(``register_op``): ``tdt::fused_block``, ``tdt::conv3x3`` and
``tdt::pixelnorm_attention``.  Its CUDA implementation is the launch code
(checks, weight preparation, launch, ``count_launch``), its CPU
implementation the plain version, and its Meta implementation the output's
shape and type, so that fake tensors and ``torch.export`` trace it as one
node.  The wrappers call the operator, so eager code and an exported
program reach the kernels by the same route; a program saved by
``torch.export.save`` loads where this package is imported.  The CUDA
implementation runs under ``torch.cuda.device`` of its first tensor, so a
launch goes to that tensor's card and stream whichever device is current;
the kernels keep their one-time launch state (shared-memory opt-in,
occupancy) per device (``csrc/conv3x3.cuh::PerDevice``).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
_SOURCES = ("conv3x3.cu", "fused_block.cu", "attention.cu")
_HEADERS = ("conv3x3.cuh", "conv_wgmma.cuh")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C entry point -> argument types (every entry point returns a cudaError_t,
# but tdt_attention_path and tdt_conv16_path, which return dispatch rules).
# Each kernel entry takes the dtype code (DTYPE_CODES) of the activations it
# runs on, just before the stream.
_SIGNATURES = {
    "tdt_conv3x3": [P, P, P, I, I, I, I, I, I, P],
    "tdt_block_prep": [P, P, I, F, F, I, I, P, P, P, I, I, I, I, I, P],
    "tdt_block_proj": [P, I, P, P, I, I, I, I, I, I, P],
    "tdt_block_conv0": [P, I, P, P, P, I, I, I, I, I, I, P],
    "tdt_block_conv1": [P, P, P, I, P, I, I, I, I, I, F, F, F, I, F, I, P],
    "tdt_pixelnorm_attention": [P, P, I, I, I, I, F, I, P],
    "tdt_attention_path": [I],
    "tdt_conv16_path": [I, I, I],
}
# The types the kernels take, by their dtype code (csrc/conv3x3.cuh: DT_F32,
# DT_BF16, DT_F16): float32 runs the 3xTF32 kernels, bf16 and fp16 the
# 16-bit forms.
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}

_lock = threading.Lock()
_lib = None
build_log = ""  # nvcc's output (ptxas register / shared-memory report)
_COUNTED = []


def counted(fn):
    """Register a kernel wrapper: ``fn.launches`` counts its launches, and
    ``fn.launches_by_dtype`` the same launches by the kernel's type."""
    fn.launches = 0
    fn.launches_by_dtype = {}
    _COUNTED.append(fn)
    return fn


def count_launch(fn, dtype: torch.dtype):
    """One launch of wrapper ``fn``'s kernel in ``dtype``."""
    fn.launches += 1
    fn.launches_by_dtype[dtype] = fn.launches_by_dtype.get(dtype, 0) + 1


def reset_launch_counts():
    for fn in _COUNTED:
        fn.launches = 0
        fn.launches_by_dtype = {}


# the low-level registration: its dispatch costs a few microseconds a call
# on the host, torch.library.custom_op's several times that
OPS = torch.library.Library("tdt", "DEF")


def register_op(schema: str, *, cuda, cpu, meta):
    """Define the operator ``tdt::<name>`` by ``schema`` (``"<name>(...) ->
    Tensor"``) with its CUDA, CPU and Meta implementations; returns its
    overload, ``torch.ops.tdt.<name>.default``."""
    name = schema.split("(", 1)[0]
    OPS.define(schema)

    def on_device(x, *args):  # the launch runs on x's card, on that card's stream
        if x.device.index == torch.cuda.current_device():  # the one-card path: no guard
            return cuda(x, *args)
        with torch.cuda.device(x.device):
            return cuda(x, *args)

    for fn, key in ((on_device, "CUDA"), (cpu, "CPU"), (meta, "Meta")):
        OPS.impl(name, fn, key)
    return getattr(torch.ops.tdt, name).default


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    return os.path.join(home, "bin", "nvcc")


def library_path() -> str:
    """Path of the kernel library for the current sources."""
    h = hashlib.sha1()
    for name in _HEADERS + _SOURCES:
        with open(os.path.join(CSRC_DIR, name), "rb") as f:
            h.update(name.encode() + b"\0" + f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"libtdt_kernels_{h.hexdigest()[:16]}.so")


def build_kernels() -> str:
    """Compile the kernel library if it is not built yet; returns its path.
    Each source compiles in its own nvcc process, all started together, and
    the objects link into one library.  Raises RuntimeError with nvcc's
    output when the build fails."""
    global build_log
    path = library_path()
    if os.path.exists(path):
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmpdir = tempfile.mkdtemp(dir=BUILD_DIR)
    try:
        objs = [os.path.join(tmpdir, f"{s}.o") for s in _SOURCES]
        procs = [subprocess.Popen([_nvcc(), *NVCC_FLAGS, "-c", "-o", obj,
                                   os.path.join(CSRC_DIR, src)],
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                  text=True)
                 for src, obj in zip(_SOURCES, objs)]
        logs = [f"== {src}\n{proc.communicate()[0]}" for src, proc in zip(_SOURCES, procs)]
        build_log = "".join(logs)
        failed = [src for src, proc in zip(_SOURCES, procs) if proc.returncode != 0]
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n{build_log}")
        tmp = os.path.join(tmpdir, "lib.so")
        link = subprocess.run([_nvcc(), "-shared", "-o", tmp, *objs],
                              capture_output=True, text=True)
        build_log += link.stdout + link.stderr
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({link.returncode}):\n{build_log}")
        os.replace(tmp, path)  # atomic: processes building at once agree on one file
    finally:
        shutil.rmtree(tmpdir, ignore_errors=True)
    return path


def load():
    """The loaded kernel library (built first if needed)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build_kernels())
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = lib
        return _lib


def check_rc(rc: int, what: str):
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc} at launch")


def check_input(name: str, t: torch.Tensor, device, ndim: int, dtype=torch.float32):
    """Raise unless t is a contiguous ``ndim``-d tensor of ``dtype`` on
    ``device`` (TypeError for the type, ValueError for the rest)."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name} must be {ndim}-d, got shape {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def kernel_dtype(name: str, t: torch.Tensor) -> torch.dtype:
    """The type a kernel runs in for input t: float32 or a 16-bit type of
    DTYPE_CODES; TypeError for any other."""
    if t.dtype not in DTYPE_CODES:
        raise TypeError(f"{name}: the kernels take {', '.join(map(str, DTYPE_CODES))}, "
                        f"got {t.dtype}")
    return t.dtype


def autograd_live(*tensors) -> bool:
    """True where autograd would record through any of ``tensors`` (None
    skipped): grad mode is on and one requires grad, or one is wrapped by a
    ``torch.func`` transform (``jvp`` carries tangents outside ``grad_fn``)."""
    ts = [t for t in tensors if isinstance(t, torch.Tensor)]
    if torch.is_grad_enabled() and any(t.requires_grad for t in ts):
        return True
    return any(torch._C._functorch.is_functorch_wrapped_tensor(t) for t in ts)


def refuse_autograd(name: str, *tensors):
    """Raise RuntimeError where autograd would record through ``tensors``:
    the kernel (and, for one rule on every device, its plain version behind
    the wrapper) defines no backward."""
    if autograd_live(*tensors):
        raise RuntimeError(f"{name} defines no backward: call it under torch.no_grad() on "
                           "tensors that need no gradient (a training forward runs the "
                           "plain path)")


def ptr(t):
    return None if t is None else t.data_ptr()


def stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream
