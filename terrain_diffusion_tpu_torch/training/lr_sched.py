"""Stateless LR schedulers: ``.get(nimg)`` maps images seen to a learning
rate (counterpart of ``terrain_diffusion_tpu/training/lr_sched.py``, kept
as its own copy)."""
from __future__ import annotations

import math


class SqrtLRScheduler:
    """lr / sqrt(max(nimg/ref_nimg, 1)) with linear warmup."""

    def __init__(self, lr: float, ref_nimg: float, warmup_nimg: float = 0):
        self.lr = lr
        self.ref_nimg = ref_nimg
        self.warmup_nimg = warmup_nimg

    def get(self, nimg: float) -> float:
        lr = self.lr / math.sqrt(max(nimg / self.ref_nimg, 1.0))
        if self.warmup_nimg > 0:
            lr = lr * min(nimg / self.warmup_nimg, 1.0)
        return lr


class CosineLRScheduler:
    def __init__(self, lr: float, total_nimg: float, warmup_nimg: float = 0,
                 final_lr: float = 0.0):
        self.lr = lr
        self.total_nimg = total_nimg
        self.warmup_nimg = warmup_nimg
        self.final_lr = final_lr

    def get(self, nimg: float) -> float:
        if self.warmup_nimg > 0 and nimg < self.warmup_nimg:
            return self.lr * nimg / self.warmup_nimg
        p = min(max((nimg - self.warmup_nimg) /
                    max(self.total_nimg - self.warmup_nimg, 1e-9), 0.0), 1.0)
        return self.final_lr + (self.lr - self.final_lr) * 0.5 * (1 + math.cos(math.pi * p))


class ConstantLRScheduler:
    def __init__(self, lr: float, warmup_nimg: float = 0):
        self.lr = lr
        self.warmup_nimg = warmup_nimg

    def get(self, nimg: float) -> float:
        if self.warmup_nimg > 0:
            return self.lr * min(nimg / self.warmup_nimg, 1.0)
        return self.lr
