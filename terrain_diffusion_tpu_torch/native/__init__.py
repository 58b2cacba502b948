"""Native (C++) host kernels: portable RNG and Perlin FBm (counterpart of
``terrain_diffusion_tpu.native``).

First-party C++ (``src/portable_rng.cpp``, ``src/perlin.cpp``, the port's own
copies) exposed over a plain C ABI through ctypes.  Build explicitly with
``python -m terrain_diffusion_tpu_torch.native.build``: importing this
package NEVER shells out to a compiler; it only loads a prebuilt
``libterrain_native.so`` from ``_build/`` beside the package when one is
present and newer than its sources.

``lib`` is the loaded wrapper, or ``None`` when the prebuilt library is
absent or stale, or ``TDTPU_DISABLE_NATIVE`` is set.  The callers
(``ops/rng_portable.fill_standard_normal``, ``ops/perlin.perlin_fbm``) then
take their vectorized numpy paths, which give the same values bit for bit.
A library built after this module was imported is loaded by
``importlib.reload`` of the module.
"""
from __future__ import annotations

import ctypes
import os
import subprocess

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_BUILD_DIR = os.path.join(os.path.dirname(_HERE), "_build")
_SO_PATH = os.path.join(_BUILD_DIR, "libterrain_native.so")
_FAIL_MARKER = os.path.join(_BUILD_DIR, "native_build_failed")
_SRCS = [
    os.path.join(_HERE, "src", "portable_rng.cpp"),
    os.path.join(_HERE, "src", "perlin.cpp"),
]


def build(force: bool = False) -> str:
    """Compile the native library with g++; returns the .so path.

    The flags are fixed and portable: no arch-specific codegen, so no fused
    multiply-add rounds differently from the numpy paths.  A failure is
    cached in a marker file so repeated calls do not retry a known-broken
    toolchain until the sources change (``force=True`` overrides both
    caches).
    """
    newest_src = max(os.path.getmtime(s) for s in _SRCS)
    if not force:
        if (os.path.exists(_SO_PATH)
                and os.path.getmtime(_SO_PATH) >= newest_src):
            return _SO_PATH
        if (os.path.exists(_FAIL_MARKER)
                and os.path.getmtime(_FAIL_MARKER) >= newest_src):
            with open(_FAIL_MARKER) as f:
                raise RuntimeError(f"native build previously failed "
                                   f"(rm {_FAIL_MARKER} to retry):\n{f.read()}")
    os.makedirs(_BUILD_DIR, exist_ok=True)
    tmp_path = f"{_SO_PATH}.{os.getpid()}.tmp"  # a loader never sees half a library
    cmd = ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", *_SRCS, "-o", tmp_path]
    try:
        subprocess.run(cmd, check=True, capture_output=True, text=True)
    except (subprocess.CalledProcessError, OSError) as e:
        detail = getattr(e, "stderr", "") or str(e)
        try:  # best effort: an unwritable build dir must not mask the
            with open(_FAIL_MARKER, "w") as f:  # actual compiler error
                f.write(f"{' '.join(cmd)}\n{detail}")
        except OSError:
            pass
        raise RuntimeError(f"native build failed: {detail}") from e
    os.replace(tmp_path, _SO_PATH)
    try:
        if os.path.exists(_FAIL_MARKER):
            os.unlink(_FAIL_MARKER)
    except OSError:
        pass
    return _SO_PATH


class _NativeLib:
    def __init__(self, path: str):
        self._dll = ctypes.CDLL(path)
        d = self._dll
        d.td_fill_standard_normal_f32.restype = None
        d.td_fill_standard_normal_f32.argtypes = [
            ctypes.c_uint64, ctypes.POINTER(ctypes.c_float), ctypes.c_int64]
        d.td_perlin_fbm_coords.restype = None
        d.td_perlin_fbm_coords.argtypes = [
            ctypes.c_int32, ctypes.c_float, ctypes.c_int32, ctypes.c_float,
            ctypes.c_float, ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_float)]

    @staticmethod
    def _fptr(a: np.ndarray):
        return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))

    def fill_standard_normal_f32(self, seed: int, out: np.ndarray) -> None:
        if out.dtype != np.float32 or not out.flags.c_contiguous:
            raise ValueError("fill_standard_normal_f32 needs a C-contiguous float32 array")
        self._dll.td_fill_standard_normal_f32(
            ctypes.c_uint64(seed), self._fptr(out), out.size)

    def perlin_fbm_coords(self, seed, frequency, octaves, lacunarity, gain,
                          xs: np.ndarray, ys: np.ndarray) -> np.ndarray:
        xs = np.ascontiguousarray(xs, dtype=np.float32)
        ys = np.ascontiguousarray(ys, dtype=np.float32)
        if xs.size != ys.size:
            raise ValueError(f"{xs.size} x coordinates for {ys.size} y coordinates")
        out = np.empty(xs.size, dtype=np.float32)
        self._dll.td_perlin_fbm_coords(
            seed, frequency, octaves, lacunarity, gain,
            self._fptr(xs), self._fptr(ys), xs.size, self._fptr(out))
        return out


def _load():
    """Load a PREBUILT library only: no compiler at import time (build with
    ``python -m terrain_diffusion_tpu_torch.native.build``)."""
    if os.environ.get("TDTPU_DISABLE_NATIVE"):
        raise ImportError("native disabled via TDTPU_DISABLE_NATIVE")
    if not os.path.exists(_SO_PATH):
        raise ImportError(
            f"no prebuilt {_SO_PATH}; run "
            "`python -m terrain_diffusion_tpu_torch.native.build`")
    newest_src = max(os.path.getmtime(s) for s in _SRCS)
    if os.path.getmtime(_SO_PATH) < newest_src:
        raise ImportError(
            f"{_SO_PATH} is older than its sources; rebuild with "
            "`python -m terrain_diffusion_tpu_torch.native.build`")
    return _NativeLib(_SO_PATH)


try:
    lib = _load()
except ImportError:
    lib = None


def get_native():
    """The loaded native library or None: the one accessor of the ops
    layer's fast paths, which take their numpy paths on None."""
    return lib
