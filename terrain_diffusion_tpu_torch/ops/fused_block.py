"""The decoder's two hand-written CUDA kernels, their wrappers and their
plain PyTorch versions.

- ``fused_block``: one whole magnitude-preserving residual block at
  inference (``csrc/fused_block.cu``), the counterpart of
  ``terrain_diffusion_tpu.ops.pallas_block.fused_block_apply``.
- ``conv3x3``: a SAME-padded 3x3 conv with a prepared HWIO weight
  (``csrc/conv3x3.cu``), the counterpart of ``fused_conv3x3_apply``.

``fused_block_reference`` / ``conv3x3_reference`` take the same arguments
and compute the same math with ``F.conv2d`` and tensor ops.  A wrapper uses
its plain version only for a tensor that lies on the CPU; for a CUDA tensor
it launches its kernel or raises.  Each wrapper counts its launches in a
plain integer attribute (``fused_block.launches``, ``conv3x3.launches``).

The kernels are compiled with nvcc into one shared library with a plain C
interface, at first use, into ``_build/`` beside this package (named by a
hash of the sources), and loaded with ctypes.
"""
from __future__ import annotations

import ctypes
import hashlib
import math
import os
import shutil
import subprocess
import tempfile
import threading

import torch

from terrain_diffusion_tpu_torch.ops.nhwc import conv2d_nhwc, hwio_to_oihw

INV_SILU_GAIN = 1.0 / 0.596  # mp_silu divisor, folded into the conv weights

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
_SOURCES = ("conv3x3.cu", "fused_block.cu")
_HEADERS = ("conv3x3.cuh",)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_lib = None
build_log = ""  # nvcc's output (ptxas register / shared-memory report)


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
    Raises RuntimeError with nvcc's output when the build fails."""
    global build_log
    path = library_path()
    if os.path.exists(path):
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp,
           *(os.path.join(CSRC_DIR, s) for s in _SOURCES)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
        build_log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{build_log}")
        os.replace(tmp, path)  # atomic: processes building at once agree on one file
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return path


def _load():
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(build_kernels())
        P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.tdt_conv3x3.argtypes = [P, P, P, I, I, I, I, I, P]
        lib.tdt_block_prologue.argtypes = [P, P, F, F, I, P, I, P, I, I, I, I, I, P]
        lib.tdt_block_conv0.argtypes = [P, P, P, P, I, I, I, I, I, P]
        lib.tdt_block_conv1.argtypes = [P, P, P, P, I, I, I, I, I, F, F, F, I, F, P]
        for fn in (lib.tdt_conv3x3, lib.tdt_block_prologue, lib.tdt_block_conv0,
                   lib.tdt_block_conv1):
            fn.restype = ctypes.c_int
        _lib = lib
        return lib


def _check_rc(rc: int, what: str):
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc} at launch")


def _check_input(name: str, t: torch.Tensor, device, ndim: int):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name} must be {ndim}-d, got shape {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _ptr(t):
    return None if t is None else t.data_ptr()


def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


# ---------------------------------------------------------------------------
# conv3x3
# ---------------------------------------------------------------------------

def conv3x3_reference(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Plain version: SAME 3x3 conv of NHWC x with a prepared HWIO weight."""
    return conv2d_nhwc(x.float(), hwio_to_oihw(w.float()), padding=1).contiguous()


def conv3x3(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """SAME-padded 3x3 conv: x (N, H, W, Cin) float32, w (3, 3, Cin, Cout)
    prepared HWIO weight (normalized, fan-in scaled, gain folded)."""
    if x.device.type == "cpu":
        return conv3x3_reference(x, w)
    _check_input("x", x, x.device, 4)
    _check_input("w", w, x.device, 4)
    N, H, W, Cin = x.shape
    if tuple(w.shape[:3]) != (3, 3, Cin):
        raise ValueError(f"w shape {tuple(w.shape)} does not fit x {tuple(x.shape)}")
    Cout = w.shape[3]
    lib = _load()
    y = torch.empty((N, H, W, Cout), device=x.device, dtype=torch.float32)
    _check_rc(lib.tdt_conv3x3(x.data_ptr(), w.data_ptr(), y.data_ptr(), N, H, W,
                              Cin, Cout, _stream(x.device)), "conv3x3")
    conv3x3.launches += 1
    return y


conv3x3.launches = 0


# ---------------------------------------------------------------------------
# fused residual block
# ---------------------------------------------------------------------------

def _silu(x):
    # bare x*sigmoid(x): the magnitude-preserving 1/0.596 is folded into
    # the following conv's weight
    return x / (1.0 + torch.exp(-x))


def _residual_coeffs(res_balance: float):
    t = float(res_balance)
    return 1.0 - t, t, math.sqrt((1.0 - t) ** 2 + t ** 2)


def fused_block_reference(x, w0, w1, c, wskip=None, x2=None, *, mode="enc",
                          pixel_norm=True, res_balance=0.3, clip_act=256.0,
                          concat_scales=None, pre_upsample=1):
    """Plain version of ``fused_block`` (same arguments, same math)."""
    xs = x.float()
    if x2 is not None:
        s1, s2 = concat_scales
        xs = torch.cat([xs * s1, x2.float() * s2], dim=-1)
    if pre_upsample == 2:
        xs = xs.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)
    if mode == "enc":
        if wskip is not None:
            xs = torch.matmul(xs, wskip.float())
        if pixel_norm:
            rms = torch.sqrt(torch.mean(xs * xs, dim=-1, keepdim=True))
            xs = xs / (1e-4 + rms)
        xres = xs
    else:
        xres = torch.matmul(xs, wskip.float()) if wskip is not None else xs
    h = conv2d_nhwc(_silu(xs), hwio_to_oihw(w0.float() * INV_SILU_GAIN), padding=1)
    if c is not None:
        h = h * c.float()[:, None, None, :]
    y = conv2d_nhwc(_silu(h), hwio_to_oihw(w1.float() * INV_SILU_GAIN), padding=1)
    a, b, norm = _residual_coeffs(res_balance)
    out = (xres * a + y * b) / norm
    if clip_act is not None:
        out = torch.clamp(out, -clip_act, clip_act)
    return out.contiguous()


def fused_block(x, w0, w1, c, wskip=None, x2=None, *, mode="enc",
                pixel_norm=True, res_balance=0.3, clip_act=256.0,
                concat_scales=None, pre_upsample=1):
    """Fused residual-block forward (inference).

    x      : (N, H, W, Cin) float32 activations (half resolution when
             pre_upsample=2).
    w0     : (3, 3, Cin', Cmid) normalized + fan-in-scaled first conv weight;
             Cin' = Cout for enc blocks with a projection (which runs first),
             else the (concatenated) input width.
    w1     : (3, 3, Cmid, Cout) normalized + scaled second conv weight.
    c      : (N, Cmid) per-channel emb gain (+1 and RMS-normalized), or None.
    wskip  : (Cin, Cout) normalized + scaled 1x1 projection, or None.
    x2     : optional same-shape second input; with concat_scales=(s1, s2)
             the block consumes mp_concat([x, x2]) (the dec skip join).

    The 1/0.596 mp_silu gain is folded into w0/w1 here, so callers pass
    plain normalized weights.
    """
    if x.device.type == "cpu":
        return fused_block_reference(
            x, w0, w1, c, wskip, x2, mode=mode, pixel_norm=pixel_norm,
            res_balance=res_balance, clip_act=clip_act,
            concat_scales=concat_scales, pre_upsample=pre_upsample)
    dev = x.device
    u = int(pre_upsample)
    if u not in (1, 2):
        raise ValueError(f"pre_upsample must be 1 or 2, got {pre_upsample}")
    if mode not in ("enc", "dec"):
        raise ValueError(f"mode must be 'enc' or 'dec', got {mode!r}")
    _check_input("x", x, dev, 4)
    N, Hs, Ws, Cx = x.shape
    H, W = Hs * u, Ws * u
    Cg = Cx
    if x2 is not None:
        _check_input("x2", x2, dev, 4)
        if x2.shape != x.shape or concat_scales is None or u != 1:
            raise ValueError("x2 needs x's shape, concat_scales and pre_upsample=1")
        Cg = 2 * Cx
    s1, s2 = (float(concat_scales[0]), float(concat_scales[1])) \
        if x2 is not None else (1.0, 1.0)
    for name, t in (("w0", w0), ("w1", w1)):
        _check_input(name, t, dev, 4)
    Cmid, Cout = w0.shape[3], w1.shape[3]
    if wskip is not None:
        _check_input("wskip", wskip, dev, 2)
        if wskip.shape[0] != Cg:
            raise ValueError(f"wskip {tuple(wskip.shape)} does not fit {Cg} input channels")
    c_main = wskip.shape[1] if (mode == "enc" and wskip is not None) else Cg
    c_res = wskip.shape[1] if wskip is not None else Cg
    if tuple(w0.shape[:3]) != (3, 3, c_main) or tuple(w1.shape[:3]) != (3, 3, Cmid) \
            or c_res != Cout:
        raise ValueError("block weights do not fit the input: "
                         f"x {tuple(x.shape)}, w0 {tuple(w0.shape)}, "
                         f"w1 {tuple(w1.shape)}, wskip "
                         f"{None if wskip is None else tuple(wskip.shape)}")
    if c is None:
        c = torch.ones((N, Cmid), device=dev, dtype=torch.float32)
    _check_input("c", c, dev, 2)
    if tuple(c.shape) != (N, Cmid):
        raise ValueError(f"c shape {tuple(c.shape)} != {(N, Cmid)}")
    w0 = (w0 * INV_SILU_GAIN).contiguous()
    w1 = (w1 * INV_SILU_GAIN).contiguous()
    lib = _load()
    stream = _stream(dev)

    def prologue(src, src2, up, proj, norm, c_src):
        c_out = proj.shape[1] if proj is not None else (2 * c_src if src2 is not None else c_src)
        out = torch.empty((N, H, W, c_out), device=dev, dtype=torch.float32)
        _check_rc(lib.tdt_block_prologue(
            src.data_ptr(), _ptr(src2), s1 if src2 is not None else 1.0, s2,
            int(up == 2), _ptr(proj), int(norm), out.data_ptr(), N, H, W,
            c_src, c_out, stream), "fused_block prologue")
        return out

    if mode == "enc":
        xs = prologue(x, x2, u, wskip, pixel_norm, Cx)
        xres = xs
    else:
        xs = prologue(x, x2, u, None, False, Cx) if (x2 is not None or u == 2) else x
        xres = prologue(xs, None, 1, wskip, False, Cg) if wskip is not None else xs
    h = torch.empty((N, H, W, Cmid), device=dev, dtype=torch.float32)
    _check_rc(lib.tdt_block_conv0(xs.data_ptr(), w0.data_ptr(), c.data_ptr(),
                                  h.data_ptr(), N, H, W, xs.shape[3], Cmid, stream),
              "fused_block conv0")
    out = torch.empty((N, H, W, Cout), device=dev, dtype=torch.float32)
    a, b, norm = _residual_coeffs(res_balance)
    _check_rc(lib.tdt_block_conv1(
        h.data_ptr(), w1.data_ptr(), xres.data_ptr(), out.data_ptr(), N, H, W,
        Cmid, Cout, a, b, norm, int(clip_act is not None),
        float(clip_act) if clip_act is not None else 0.0, stream),
        "fused_block conv1")
    fused_block.launches += 1
    return out


fused_block.launches = 0


def reset_launch_counts():
    fused_block.launches = 0
    conv3x3.launches = 0
