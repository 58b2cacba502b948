"""InfiniteTensor: lazy, unbounded, seed-consistent tiled tensors.

Counterpart of ``terrain_diffusion_tpu.runtime.infinite_tensor``:

- A tensor is defined by a window function ``f`` evaluated on an unbounded
  integer grid of overlapping windows (``TensorWindow``).
- Slicing sums overlapping window outputs (the weight channel turns the sum
  into a blended average).
- Window outputs are cached in a tile store keyed by (tensor_id, window
  index), so results do not depend on query order.

Evaluation is planned, not recursive: a read first walks the dependency DAG
and collects every missing window per tensor, then evaluates tensors
parents-first with windows grouped into padded batch buckets, so each stage
runs a few batched calls.  Windows are summed in sorted index order.

Window functions are vectorized: ``f(ctxs, *arg_stacks) -> (B, *window)``
with ``ctxs`` an int64 array (B, ndim) of window indices and one stacked
region tensor (B, ...) per argument tensor.  B is padded up to the next
batch bucket by repeating the last window, so stage models see a bounded
set of batch sizes.
"""
from __future__ import annotations

import numpy as np
import torch

from terrain_diffusion_tpu_torch.runtime.tile_store import MemoryTileStore
from terrain_diffusion_tpu_torch.runtime.window import TensorWindow


class InfiniteTensor:
    def __init__(self, f, output_window: TensorWindow, *, args: tuple = (),
                 args_windows: tuple = (), batch_buckets=(1,),
                 tile_store: MemoryTileStore, tensor_id: str, device):
        self.f = f
        self.output_window = output_window
        self.args = tuple(args)
        self.args_windows = tuple(args_windows)
        if len(self.args) != len(self.args_windows):
            raise ValueError("one window per argument tensor")
        self.batch_buckets = tuple(sorted({int(b) for b in batch_buckets}))
        self.tile_store = tile_store
        self.tensor_id = tensor_id
        self.device = torch.device(device)

    # ------------------------------------------------------------------
    def read(self, ranges) -> torch.Tensor:
        """Summed window contributions over `ranges` ((start, stop) per dim)."""
        ensure_regions_multi([(self, [ranges])])
        return self._assemble(ranges)

    # ------------------------------------------------------------------
    def _contains(self, idx) -> bool:
        return self.tile_store.contains(self.tensor_id, idx)

    def _collect_needed(self, idx_set, need):
        mine = need.setdefault(id(self), set())
        new = {i for i in idx_set if i not in mine and not self._contains(i)}
        if not new:
            return
        mine |= new
        for arg, win in zip(self.args, self.args_windows):
            parent = set()
            for idx in new:
                parent |= set(arg.output_window.windows_overlapping(win.box(idx)))
            arg._collect_needed(parent, need)

    def _pick_bucket(self, n: int) -> int:
        for b in self.batch_buckets:
            if b >= n:
                return b
        return self.batch_buckets[-1]

    def _evaluate_windows(self, idxs):
        max_b = self.batch_buckets[-1]
        for i0 in range(0, len(idxs), max_b):
            self._evaluate_chunk(idxs[i0:i0 + max_b])

    def _evaluate_chunk(self, chunk):
        # planned parents may have been evicted since planning: restore them
        # in batches rather than one window at a time during assembly
        for a, win in zip(self.args, self.args_windows):
            needed = set()
            for idx in chunk:
                needed |= set(a.output_window.windows_overlapping(win.box(idx)))
            missing = sorted(i for i in needed if not a._contains(i))
            if missing:
                a._evaluate_windows(missing)
        pad = self._pick_bucket(len(chunk)) - len(chunk)
        ctxs = np.asarray(list(chunk) + [chunk[-1]] * pad, dtype=np.int64)
        stacks = []
        for a, win in zip(self.args, self.args_windows):
            regions = [a._assemble(win.box(idx)) for idx in chunk]
            stacks.append(torch.stack(regions + [regions[-1]] * pad))
        out = self.f(ctxs, *stacks)
        want = (len(ctxs), *self.output_window.size)
        if tuple(out.shape) != want:
            raise RuntimeError(f"window fn of {self.tensor_id} returned "
                               f"{tuple(out.shape)}, expected {want}")
        for i, idx in enumerate(chunk):
            # own storage per window, so eviction frees what it accounts
            self.tile_store.put(self.tensor_id, idx, out[i].clone())

    def _tile(self, idx) -> torch.Tensor:
        t = self.tile_store.get(self.tensor_id, idx)
        if t is None:  # evicted or never planned: recompute on demand
            self._evaluate_chunk([idx])
            t = self.tile_store.get(self.tensor_id, idx)
            if t is None:
                raise RuntimeError(f"window {idx} of {self.tensor_id} unavailable "
                                   "after recompute (tile cache too small?)")
        return t

    def _assemble(self, ranges) -> torch.Tensor:
        shape = tuple(b - a for a, b in ranges)
        out = torch.zeros(shape, dtype=torch.float32, device=self.device)
        for idx in sorted(self.output_window.windows_overlapping(ranges)):
            t = self._tile(idx)
            src, dst = [], []
            for (ws, we), (a, b) in zip(self.output_window.box(idx), ranges):
                o0, o1 = max(ws, a), min(we, b)
                src.append(slice(o0 - ws, o1 - ws))
                dst.append(slice(o0 - a, o1 - a))
            out[tuple(dst)] += t[tuple(src)]
        return out


def ensure_regions_multi(requests):
    """Plan and evaluate every window needed by all `(tensor, ranges_list)`
    requests in one pass over the shared dependency DAG, parents first, so
    windows that several roots need land in the same stage batches."""
    need: dict = {}
    roots = []
    for tensor, ranges_list in requests:
        idxs = set()
        for ranges in ranges_list:
            idxs |= set(tensor.output_window.windows_overlapping(ranges))
        tensor._collect_needed(idxs, need)
        roots.append(tensor)
    order, seen = [], set()

    def visit(t):
        if id(t) in seen:
            return
        seen.add(id(t))
        for a in t.args:
            visit(a)
        order.append(t)

    for r in roots:
        visit(r)
    for t in order:
        n = need.get(id(t))
        if n:
            t._evaluate_windows(sorted(n))
