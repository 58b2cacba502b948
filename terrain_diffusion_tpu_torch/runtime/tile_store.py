"""Per-window output cache for the infinite-tensor runtime (counterpart of
``terrain_diffusion_tpu.runtime.tile_store.MemoryTileStore``).

Entries are tensors on the pipeline's device; the budget counts their bytes.
"""
from __future__ import annotations

import collections
import threading
from typing import Optional

import torch


class MemoryTileStore:
    """Byte-budgeted LRU of window outputs keyed by (tensor_id, window index)."""

    def __init__(self, cache_size_bytes: Optional[int] = None):
        self.cache_size_bytes = cache_size_bytes
        self._data: "collections.OrderedDict[tuple, torch.Tensor]" = collections.OrderedDict()
        self._bytes = 0
        self._lock = threading.Lock()

    @staticmethod
    def _key(tensor_id: str, idx) -> tuple:
        return (tensor_id, tuple(int(i) for i in idx))

    @staticmethod
    def _nbytes(t: torch.Tensor) -> int:
        return t.numel() * t.element_size()

    def get(self, tensor_id: str, idx):
        k = self._key(tensor_id, idx)
        with self._lock:
            t = self._data.get(k)
            if t is not None:
                self._data.move_to_end(k)
            return t

    def contains(self, tensor_id: str, idx) -> bool:
        with self._lock:
            return self._key(tensor_id, idx) in self._data

    def put(self, tensor_id: str, idx, t: torch.Tensor):
        k = self._key(tensor_id, idx)
        with self._lock:
            if k in self._data:
                self._bytes -= self._nbytes(self._data[k])
            self._data[k] = t
            self._data.move_to_end(k)
            self._bytes += self._nbytes(t)
            if self.cache_size_bytes is not None:
                while self._bytes > self.cache_size_bytes and len(self._data) > 1:
                    _, old = self._data.popitem(last=False)
                    self._bytes -= self._nbytes(old)

    def clear(self):
        with self._lock:
            self._data.clear()
            self._bytes = 0
