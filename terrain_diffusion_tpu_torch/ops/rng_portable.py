"""Portable RNG: PCG64 (64-bit LCG + XSH-RR 64/32) + Marsaglia polar normals.

Counterpart of ``terrain_diffusion_tpu.ops.rng_portable`` (its NumPy path):
the same (seed, size) reproduces the identical float stream, bit for bit.
LCG states advance in blocks through precomputed ``M^i`` / increment prefix
tables (64-bit wraparound arithmetic), and the Marsaglia polar rejection
loop is reproduced by keeping accepted pairs in stream order.
"""
from __future__ import annotations

import time

import numpy as np

PCG64_MULT = 6364136223846793005
PCG64_INC = 1442695040888963407
_MASK64 = 0xFFFFFFFFFFFFFFFF
_BLOCK = 8192  # outputs per vectorized LCG block


def _build_jump_tables(n: int):
    """After i steps, state = mult[i]*s0 + inc[i] (mod 2^64)."""
    mult = np.empty(n + 1, dtype=np.uint64)
    inc = np.empty(n + 1, dtype=np.uint64)
    m, c = 1, 0
    for i in range(n + 1):
        mult[i] = m
        inc[i] = c
        m = (m * PCG64_MULT) & _MASK64
        c = (c * PCG64_MULT + PCG64_INC) & _MASK64
    return mult, inc


_JUMP_MULT, _JUMP_INC = _build_jump_tables(_BLOCK)


def pcg64_next(state: int) -> tuple[int, int]:
    """One PCG64 XSH-RR 64/32 step: (new_state, 32-bit output)."""
    state = (state * PCG64_MULT + PCG64_INC) & _MASK64
    x = (((state >> 18) ^ state) >> 27) & 0xFFFFFFFF
    rot = state >> 59
    return state, ((x >> rot) | (x << ((32 - rot) & 31))) & 0xFFFFFFFF


def next_seed(seed: int | None) -> int:
    """A new 64-bit seed from a parent seed, or from the clock when None/0:
    two PCG64 outputs fill 64 bits."""
    state = (int(seed) & _MASK64) if seed is not None else 0
    if state == 0:
        state = int(time.perf_counter_ns()) & _MASK64
    state, lo = pcg64_next(state)
    state, hi = pcg64_next(state)
    return int(((hi << 32) | lo) & _MASK64)


def _pcg64_outputs_block(state: int, n: int):
    """n 32-bit outputs starting from `state`; returns (new_state, uint32[n])."""
    with np.errstate(over="ignore"):
        states = _JUMP_MULT[1:n + 1] * np.uint64(state) + _JUMP_INC[1:n + 1]
        x = ((states >> np.uint64(18)) ^ states) >> np.uint64(27)
        x = (x & np.uint64(0xFFFFFFFF)).astype(np.uint32)
        rot = (states >> np.uint64(59)).astype(np.uint32)
        out = (x >> rot) | (x << ((np.uint32(32) - rot) & np.uint32(31)))
    return int(states[-1]), out


def fill_standard_normal(seed: int, out: np.ndarray) -> None:
    """Fill the C-contiguous array `out` with standard normals from the
    portable stream (Marsaglia polar, pairs kept in stream order)."""
    if not out.flags.c_contiguous:
        raise ValueError("fill_standard_normal needs a C-contiguous array")
    flat = out.reshape(-1)
    n = flat.size
    state = int(seed) & _MASK64
    inv_2p32 = 1.0 / 4294967296.0
    filled = 0
    while filled < n:
        need_pairs = ((n - filled + 1) // 2) + 8
        gen_pairs = min(max(int(need_pairs * 1.35) + 16, 64), _BLOCK // 2)
        state, u = _pcg64_outputs_block(state, gen_pairs * 2)
        v1 = 2.0 * (u[0::2].astype(np.float64) + 1.0) * inv_2p32 - 1.0
        v2 = 2.0 * (u[1::2].astype(np.float64) + 1.0) * inv_2p32 - 1.0
        s = v1 * v1 + v2 * v2
        ok = (s > 0.0) & (s < 1.0)
        if not np.any(ok):
            continue
        f = np.sqrt(-2.0 * np.log(s[ok]) / s[ok])
        pair_norms = np.empty(ok.sum() * 2, dtype=np.float64)
        pair_norms[0::2] = v1[ok] * f
        pair_norms[1::2] = v2[ok] * f
        take = min(pair_norms.size, n - filled)
        flat[filled:filled + take] = pair_norms[:take].astype(out.dtype)
        filled += take


def tile_seed(base_seed: int, ty: int, tx: int) -> int:
    """Portable 64-bit seed from (base_seed, tile_y, tile_x): golden-ratio
    Weyl hashing."""
    h = (int(base_seed) & _MASK64) * 0x9E3779B9
    h = (h + (int(ty) & 0xFFFFFFFF)) & _MASK64
    return (h * 0x9E3779B9 + (int(tx) & 0xFFFFFFFF)) & _MASK64
