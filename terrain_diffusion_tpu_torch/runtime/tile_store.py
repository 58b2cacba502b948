"""Per-window output caches for the infinite-tensor runtime (counterpart of
``terrain_diffusion_tpu.runtime.tile_store``).

- ``MemoryTileStore(cache_size_bytes)``: in-memory LRU of tensors on the
  pipeline's device; the budget counts their bytes.
- ``HDF5TileStore(path, mode, compression, ...)``: the persistent world
  cache, with the JAX package's file layout, so a world written by one
  package opens in the other: one float32 dataset per window under
  ``{tensor_id}/{i}_{j}_...``, the pipeline parameters as JSON in the
  ``WORLD_PIPELINE_PARAMS`` file attribute, and a small in-memory LRU of
  host arrays in front.  It keeps numpy arrays; ``InfiniteTensor`` moves
  windows between it and the device.
"""
from __future__ import annotations

import collections
import json
import threading
from typing import Optional

import numpy as np
import torch


class MemoryTileStore:
    """Byte-budgeted LRU of window outputs keyed by (tensor_id, window index)."""

    host = False  # entries stay where the window function made them

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

    def clear(self, tensor_id: Optional[str] = None):
        with self._lock:
            if tensor_id is None:
                self._data.clear()
                self._bytes = 0
            else:
                for k in [k for k in self._data if k[0] == tensor_id]:
                    self._bytes -= self._nbytes(self._data.pop(k))

    def close(self):
        self.clear()


class HDF5TileStore:
    """Persistent tile store over HDF5 with an LRU read cache of host arrays."""

    PARAMS_ATTR = "WORLD_PIPELINE_PARAMS"
    host = True  # entries are numpy arrays

    def __init__(self, path: str, mode: str = "a", compression: Optional[str] = "gzip",
                 compression_opts: Optional[int] = 4, cache_size_tiles: int = 100):
        import h5py

        self.path = path
        self.file = h5py.File(path, mode)
        self.compression = compression
        self.compression_opts = compression_opts
        self._cache: "collections.OrderedDict[tuple, np.ndarray]" = collections.OrderedDict()
        self._cache_size = cache_size_tiles
        self._lock = threading.Lock()

    @staticmethod
    def _name(tensor_id: str, idx) -> str:
        return f"{tensor_id}/" + "_".join(str(int(i)) for i in idx)

    def _remember(self, k, arr):
        self._cache[k] = arr
        self._cache.move_to_end(k)
        while len(self._cache) > self._cache_size:
            self._cache.popitem(last=False)

    def get(self, tensor_id: str, idx):
        k = MemoryTileStore._key(tensor_id, idx)
        with self._lock:
            if k in self._cache:
                self._cache.move_to_end(k)
                return self._cache[k]
            name = self._name(tensor_id, idx)
            if name not in self.file:
                return None
            arr = np.asarray(self.file[name])
            self._remember(k, arr)
            return arr

    def contains(self, tensor_id: str, idx) -> bool:
        with self._lock:
            return (MemoryTileStore._key(tensor_id, idx) in self._cache
                    or self._name(tensor_id, idx) in self.file)

    def put(self, tensor_id: str, idx, arr: np.ndarray):
        name = self._name(tensor_id, idx)
        with self._lock:
            if name in self.file:
                del self.file[name]
            kwargs = {}
            if self.compression is not None:
                kwargs = dict(compression=self.compression,
                              compression_opts=self.compression_opts)
            self.file.create_dataset(name, data=arr, **kwargs)
            self._remember(MemoryTileStore._key(tensor_id, idx), arr)

    def clear(self, tensor_id: Optional[str] = None):
        with self._lock:
            if tensor_id is None:
                for key in list(self.file.keys()):
                    del self.file[key]
                self._cache.clear()
            else:
                if tensor_id in self.file:
                    del self.file[tensor_id]
                for k in [k for k in self._cache if k[0] == tensor_id]:
                    del self._cache[k]

    # -- pipeline params attribute ---------------------------------------
    def get_params(self):
        raw = self.file.attrs.get(self.PARAMS_ATTR)
        return json.loads(raw) if raw is not None else None

    def set_params(self, params: dict):
        self.file.attrs[self.PARAMS_ATTR] = json.dumps(params, sort_keys=True)
        self.file.flush()

    def flush(self):
        self.file.flush()

    def close(self):
        try:
            self.file.close()
        except Exception:  # noqa: BLE001 - already closed or never opened
            pass
