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

Windows live in the tile store: on the pipeline's device in the memory
store, as float32 host arrays in the HDF5 store (``tile_store.host``), which
this module moves to and from the device.

``device_cache_tiles > 0`` puts a ``DeviceTileAtlas`` in front of the store:
one preallocated float32 pool of windows on the tensor's device, with LRU
slots.  Child stages then take their parent regions straight from the pools
(``assemble_from_atlas``), and ``read_device`` assembles a region there.
With ``defer_host`` the pool is the canonical cache: window batches are not
written to the store when they are computed, and a window reaches the store
only when a host-side read gathers it (``_host_tile``).  ``f_fused`` then
evaluates a chunk in one call: it assembles the parents from their pools,
computes, and writes the outputs into this tensor's pool.

Window functions are vectorized: ``f(ctxs, *arg_stacks) -> (B, *window)``
with ``ctxs`` an int64 array (B, ndim) of window indices and one stacked
region tensor (B, ...) per argument tensor.  B is padded up to the next
batch bucket by repeating the last window, so stage models see a bounded
set of batch sizes.  ``f_fused(ctxs, out_atlas, out_slots, arg_views)``
takes the same padded ``ctxs``, one ``(atlas, slots, offs, valid)`` view
per argument tensor (``_traced_geometry`` of the padded boxes) and writes
its first ``len(out_slots)`` output rows into ``out_atlas[out_slots]``.
"""
from __future__ import annotations

import collections

import numpy as np
import torch

from terrain_diffusion_tpu_torch.runtime.tile_store import HDF5TileStore, MemoryTileStore
from terrain_diffusion_tpu_torch.runtime.window import TensorWindow


class DeviceTileAtlas:
    """Fixed-capacity pool of window outputs on the device ("tile atlas").

    Windows live at *slots* of one preallocated (capacity, *window) float32
    tensor; a stage batch is written into it with one ``index_copy_``, and
    a region is assembled from it by slot indices (``assemble_from_atlas``).
    Eviction is LRU slot reuse; the tile store, or recomputation, stays
    behind it.
    """

    # per-atlas device-memory budget for growth (see grow_to)
    DEFAULT_MAX_BYTES = 1 << 30

    def __init__(self, capacity: int, max_bytes: int | None = None, device=None):
        self.capacity = int(capacity)
        self.max_bytes = int(max_bytes or self.DEFAULT_MAX_BYTES)
        self.device = torch.device(device) if device is not None else None
        self._atlas = None  # made at the first write: (capacity, *window) float32
        self._slots: "collections.OrderedDict[tuple, int]" = collections.OrderedDict()
        self._free: list | None = None

    def _ensure(self, row_shape, device=None):
        if self._atlas is None:
            device = self.device if self.device is not None else device
            self._atlas = torch.zeros((self.capacity, *row_shape), dtype=torch.float32,
                                      device=device)
            self._free = list(range(self.capacity - 1, -1, -1))

    def grow_to(self, n_tiles: int, row_shape: tuple | None = None) -> int:
        """Grow the pool so that at least `n_tiles` windows fit at once,
        within `max_bytes` (a power of two, else the budget's row count);
        every slot keeps its row.  Returns the capacity.

        A coalesced plan can need more windows live at once than the
        configured capacity; without growth its parent windows are evicted
        before their consumer stage runs, and every miss recomputes one
        window at a time."""
        if n_tiles <= self.capacity:
            return self.capacity
        new_cap = _next_pow2(n_tiles)
        shape = tuple(self._atlas.shape[1:]) if self._atlas is not None else row_shape
        if shape is not None:
            row_bytes = 4 * int(np.prod(shape))
            new_cap = min(new_cap, max(self.max_bytes // row_bytes, 1))
            if new_cap <= self.capacity:
                return self.capacity
        if self._atlas is not None:
            pad = self._atlas.new_zeros((new_cap - self.capacity, *self._atlas.shape[1:]))
            self._atlas = torch.cat([self._atlas, pad])
            self._free = list(range(new_cap - 1, self.capacity - 1, -1)) + (self._free or [])
        self.capacity = new_cap
        return self.capacity

    def slot(self, idx):
        """The slot of window `idx` (marked most recently used), or None."""
        st = self._slots.get(tuple(idx))
        if st is not None:
            self._slots.move_to_end(tuple(idx))
        return st

    def reserve(self, idxs, row_shape, device=None) -> np.ndarray:
        """Assign slots to `idxs` without writing, evicting the least recently
        used.  More idxs than the capacity wrap (early idxs are evicted within
        the call): only the tail stays mapped, which the store-backed paths
        survive (a miss recomputes) but the fused path does not, so its
        caller checks the capacity first."""
        self._ensure(tuple(row_shape), device)
        slots = []
        for idx in idxs:
            k = tuple(idx)
            st = self._slots.pop(k, None)
            if st is None:
                st = self._free.pop() if self._free else self._slots.popitem(last=False)[1]
            self._slots[k] = st
            slots.append(st)
        return np.asarray(slots, np.int64)

    def put_batch(self, idxs, batch: torch.Tensor):
        """Write rows ``batch[:len(idxs)]`` into the slots of `idxs`, in one
        ``index_copy_``; len(idxs) must not exceed the capacity (a wrapped
        slot would be written twice in one copy, in no set order on the
        card).  Rows past len(idxs) (bucket padding) are not written: the
        JAX package aims them at the last slot only so that its write
        compiles once per bucket, and an eager write has no program to
        bound."""
        slots = self.reserve(idxs, tuple(batch.shape[1:]), batch.device)
        self._atlas.index_copy_(0, torch.as_tensor(slots, device=self._atlas.device),
                                batch[:len(idxs)].to(self._atlas.device, torch.float32))

    def fetch_rows(self, slots) -> torch.Tensor:
        """The rows at `slots`, gathered in one call into a new tensor on the
        pool's device."""
        return self._atlas[torch.as_tensor(np.asarray(slots, np.int64),
                                           device=self._atlas.device)]

    def clear(self):
        self._slots.clear()
        if self._atlas is not None:
            self._free = list(range(self.capacity - 1, -1, -1))

    def __len__(self):
        return len(self._slots)


def _next_pow2(n: int) -> int:
    k = 1
    while k < n:
        k *= 2
    return k


def assemble_from_atlas(atlas: torch.Tensor, slots, offs, valid, region_shape) -> torch.Tensor:
    """(B, *region_shape) regions, each the sum of up to K atlas rows.

    ``slots`` (B, K), ``offs`` (B, K, 2) and ``valid`` (B, K) (numpy or
    tensors) give each region's tiles: the atlas slot, the tile's (y, x)
    offset from the region's corner and a 0/1 weight.  Each region is built
    on a canvas padded by one tile per side; tile k of every region is read
    from the atlas, multiplied by its weight and added at its offset with a
    gather and a scatter of unique canvas indices per row, k = 0..K-1 in
    turn, so every pixel sums its tiles in slot order (sorted window index),
    as ``InfiniteTensor._assemble`` does.  No atomic add: its order would be
    unspecified on the card.  The canvas centre is the region; parts of
    tiles outside it fall away."""
    dev = atlas.device
    C, th, tw = atlas.shape[1:]
    rc, rh, rw = region_shape
    if rc != C:
        raise ValueError(f"region {tuple(region_shape)} does not match atlas rows "
                         f"{tuple(atlas.shape[1:])}")
    slots = torch.as_tensor(np.asarray(slots, np.int64), device=dev)
    offs = torch.as_tensor(np.asarray(offs, np.int64), device=dev)
    valid = torch.as_tensor(np.asarray(valid, np.float32), device=dev)
    B, K = slots.shape
    ch, cw = rh + 2 * th, rw + 2 * tw
    canvas = torch.zeros((B, C, ch * cw), dtype=torch.float32, device=dev)
    local = (torch.arange(th, device=dev)[:, None] * cw
             + torch.arange(tw, device=dev)[None, :]).reshape(1, 1, th * tw)
    for k in range(K):
        tile = atlas[slots[:, k]] * valid[:, k, None, None, None]
        corner = (offs[:, k, 0] + th) * cw + offs[:, k, 1] + tw
        idx = (corner[:, None, None] + local).expand(B, C, th * tw)
        canvas.scatter_(2, idx, canvas.gather(2, idx) + tile.reshape(B, C, th * tw))
    return canvas.reshape(B, C, ch, cw)[:, :, th:th + rh, tw:tw + rw]


def _static_k(window: TensorWindow, box) -> int:
    """K for ``_traced_geometry``: an upper bound on how many windows can
    overlap a region of this shape at any alignment, a power of two.  It
    depends on the region's shape only; the extra entries are masked zero
    tiles."""
    k = 1
    for (a, b), t, s in zip(box[1:], window.size[1:], window.stride[1:]):
        k *= -((b - a + t) // -s)  # ceil((R + T) / S)
    return _next_pow2(k)


def _traced_geometry(window: TensorWindow, boxes, slot_of):
    """(slots (B, K) int32, offs (B, K, 2) int32, valid (B, K) float32, K)
    for ``assemble_from_atlas``, or None if a needed window has no slot.
    The boxes share one shape and span the window's whole channel range."""
    per_box = []
    k_max = 1
    for box in boxes:
        idxs = sorted(window.windows_overlapping(box))
        entries = []
        for idx in idxs:
            st = slot_of(idx)
            if st is None:
                return None
            wbox = window.box(idx)
            if tuple(wbox[0]) != tuple(box[0]):
                return None  # partial channel coverage: host path
            entries.append((st, wbox[1][0] - box[1][0], wbox[2][0] - box[2][0]))
        per_box.append(entries)
        k_max = max(k_max, len(entries))
    K = _static_k(window, boxes[0])
    if k_max > K:
        raise AssertionError((k_max, K))
    B = len(boxes)
    slots = np.zeros((B, K), np.int32)
    offs = np.zeros((B, K, 2), np.int32)
    valid = np.zeros((B, K), np.float32)
    for b, entries in enumerate(per_box):
        for k, (st, oy, ox) in enumerate(entries):
            slots[b, k] = st
            offs[b, k, 0] = oy
            offs[b, k, 1] = ox
            valid[b, k] = 1.0
    return slots, offs, valid, K


class InfiniteTensor:
    def __init__(self, f, output_window: TensorWindow, *, args: tuple = (),
                 args_windows: tuple = (), batch_buckets=(1,),
                 tile_store: MemoryTileStore | HDF5TileStore, tensor_id: str, device,
                 shape=None, device_cache_tiles: int = 0, defer_host: bool = False,
                 f_fused=None):
        self.f = f
        # per dim, its extent where it is bounded (the channel dim), else None
        self.shape = tuple(shape) if shape is not None else (None,) * len(output_window.size)
        self.output_window = output_window
        self.args = tuple(args)
        self.args_windows = tuple(args_windows)
        if len(self.args) != len(self.args_windows):
            raise ValueError("one window per argument tensor")
        self.batch_buckets = tuple(sorted({int(b) for b in batch_buckets}))
        self.tile_store = tile_store
        self.tensor_id = tensor_id
        self.device = torch.device(device)
        self.device_cache = (DeviceTileAtlas(device_cache_tiles, device=self.device)
                             if device_cache_tiles > 0 else None)
        # defer_host holds only with a device cache: the store then receives
        # a window only when a host-side read gathers it (an evicted window
        # that never reached the store is recomputed)
        self.defer_host = bool(defer_host) and self.device_cache is not None
        # the one-call path needs its outputs to stay in the pool
        self.f_fused = f_fused if self.defer_host else None

    # ------------------------------------------------------------------
    def __getitem__(self, key) -> np.ndarray:
        """``t[:, i0:i1, j0:j1]``: the region as a host float32 array, as the
        JAX package returns it.  ``:`` needs a bounded dim; an unbounded one
        takes explicit start and stop coordinates (no wrap-around)."""
        if not isinstance(key, tuple):
            key = (key,)
        if len(key) != len(self.shape):
            raise IndexError(f"need a {len(self.shape)}-d index")
        ranges = []
        for extent, k in zip(self.shape, key):
            if isinstance(k, slice):
                start, stop = k.start, k.stop
                if start is None and stop is None and extent is not None:
                    start, stop = 0, extent
                if start is None or stop is None or k.step not in (None, 1):
                    raise IndexError("unbounded dims need explicit start:stop coordinates")
                ranges.append((int(start), int(stop)))
            else:
                ranges.append((int(k), int(k) + 1))
        with torch.no_grad():  # inference: the stage forwards take the kernels
            return self.read(ranges).cpu().numpy()

    def read(self, ranges) -> torch.Tensor:
        """Summed window contributions over `ranges` ((start, stop) per dim),
        assembled from the tile store on the tensor's device."""
        self.ensure_region(ranges)
        return self._assemble(ranges)

    def read_device(self, ranges) -> torch.Tensor:
        """Like read(), but assembled from the device cache when every
        overlapping window has a slot there (no store round trip); else as
        read() assembles it."""
        self.ensure_region(ranges)
        if self.device_cache is not None:
            geo = _traced_geometry(self.output_window, [tuple(map(tuple, ranges))],
                                   self.device_cache.slot)
            if geo is not None:
                slots, offs, valid, _ = geo
                return assemble_from_atlas(self.device_cache._atlas, slots, offs, valid,
                                           tuple(b - a for a, b in ranges))[0]
        return self._assemble(ranges)

    def clear_cache(self):
        """Drop this tensor's windows and its parents', in the store and in
        the device caches."""
        self.tile_store.clear(self.tensor_id)
        if self.device_cache is not None:
            self.device_cache.clear()
        for a in self.args:
            a.clear_cache()

    # ------------------------------------------------------------------
    def ensure_region(self, ranges):
        self.ensure_regions([ranges])

    def ensure_regions(self, ranges_list):
        """Plan and evaluate every window that all of `ranges_list` need, in
        one pass (their missing windows share stage batches)."""
        ensure_regions_multi([(self, ranges_list)])

    def _contains(self, idx) -> bool:
        """In the store, or in the device cache (deferred host copies)."""
        if self.tile_store.contains(self.tensor_id, idx):
            return True
        return self.device_cache is not None and self.device_cache.slot(idx) is not None

    def _collect_needed(self, idx_set, need, touched=None):
        mine = need.setdefault(id(self), set())
        if touched is not None:
            touched.setdefault(id(self), set()).update(idx_set)
        new = {i for i in idx_set if i not in mine and not self._contains(i)}
        if not new:
            return
        mine |= new
        for arg, win in zip(self.args, self.args_windows):
            parent = set()
            for idx in new:
                parent |= set(arg.output_window.windows_overlapping(win.box(idx)))
            arg._collect_needed(parent, need, touched)

    def _pick_bucket(self, n: int) -> int:
        for b in self.batch_buckets:
            if b >= n:
                return b
        return self.batch_buckets[-1]

    def _evaluate_windows(self, idxs):
        max_b = self.batch_buckets[-1]
        if self.device_cache is not None:
            # a chunk larger than the pool would wrap slots within one write
            max_b = min(max_b, self.device_cache.capacity)
        for i0 in range(0, len(idxs), max_b):
            self._evaluate_chunk(idxs[i0:i0 + max_b])

    def _evaluate_fused(self, chunk) -> bool:
        """One call: the parents assembled from their pools, the stage
        computed and its outputs written into this tensor's pool, all inside
        ``f_fused``.  False (the caller takes the staged path) unless every
        parent window of the chunk has a slot."""
        if len(chunk) > self.device_cache.capacity:
            # slots wrapped within the chunk would alias in the fused write
            return False
        pad = self._pick_bucket(len(chunk)) - len(chunk)
        padded = list(chunk) + [chunk[-1]] * pad
        arg_views = []
        for a, win in zip(self.args, self.args_windows):
            if a.device_cache is None:
                return False
            geo = _traced_geometry(a.output_window, [win.box(idx) for idx in padded],
                                   a.device_cache.slot)
            if geo is None:
                return False
            slots, offs, valid, _ = geo
            arg_views.append((a.device_cache._atlas, slots, offs, valid))
        out_slots = self.device_cache.reserve(chunk, self.output_window.size)
        self.f_fused(np.asarray(padded, dtype=np.int64), self.device_cache._atlas,
                     out_slots, arg_views)
        return True

    def _ensure_parent_windows(self, chunk):
        """Evaluate every missing parent window of `chunk` in batches, rather
        than one at a time as assembly misses them."""
        for a, win in zip(self.args, self.args_windows):
            needed = set()
            for idx in chunk:
                needed |= set(a.output_window.windows_overlapping(win.box(idx)))
            missing = sorted(i for i in needed if not a._contains(i))
            if missing:
                a._evaluate_windows(missing)

    def _evaluate_chunk(self, chunk):
        if self.f_fused is not None and self._evaluate_fused(chunk):
            return
        if self.args:
            # planned parents may have been evicted since planning (or this is
            # an on-demand evaluation): restore them in batches, then give the
            # one-call path a second chance
            self._ensure_parent_windows(chunk)
            if self.f_fused is not None and self._evaluate_fused(chunk):
                return
        pad = self._pick_bucket(len(chunk)) - len(chunk)
        ctxs = np.asarray(list(chunk) + [chunk[-1]] * pad, dtype=np.int64)
        stacks = []
        for a, win in zip(self.args, self.args_windows):
            boxes = [win.box(idx) for idx in chunk] + [win.box(chunk[-1])] * pad
            stack = a._assemble_stack_device(boxes)
            if stack is None:
                regions = [a._assemble(box) for box in boxes[:len(chunk)]]
                stack = torch.stack(regions + [regions[-1]] * pad)
            stacks.append(stack)
        out = self.f(ctxs, *stacks)
        want = (len(ctxs), *self.output_window.size)
        if tuple(out.shape) != want:
            raise RuntimeError(f"window fn of {self.tensor_id} returned "
                               f"{tuple(out.shape)}, expected {want}")
        if self.device_cache is not None:
            self.device_cache.put_batch(chunk, out)
            if self.defer_host:
                return
        if self.tile_store.host:  # float32 whatever the compute type, as JAX stores
            host = out.float().cpu().numpy()
            for i, idx in enumerate(chunk):
                self.tile_store.put(self.tensor_id, idx, host[i])
            return
        for i, idx in enumerate(chunk):
            # own storage per window, so eviction frees what it accounts
            self.tile_store.put(self.tensor_id, idx, out[i].clone())

    def _store_rows(self, idxs, rows: torch.Tensor):
        """Put window rows gathered from the device cache into the store."""
        if self.tile_store.host:
            rows = rows.cpu().numpy()
            for i, idx in enumerate(idxs):
                self.tile_store.put(self.tensor_id, idx, np.ascontiguousarray(rows[i]))
            return
        for i, idx in enumerate(idxs):
            self.tile_store.put(self.tensor_id, idx, rows[i].clone())

    def _host_tile(self, idx, _retry: bool = True) -> torch.Tensor:
        """Window `idx` on the tensor's device: from the store, else gathered
        from the device cache into the store, else recomputed."""
        t = self.tile_store.get(self.tensor_id, idx)
        if t is None and self.device_cache is not None:
            st = self.device_cache.slot(idx)
            if st is not None:
                self._store_rows([idx], self.device_cache.fetch_rows([st]))
                t = self.tile_store.get(self.tensor_id, idx)
        if t is None:
            if not _retry:
                raise RuntimeError(f"window {idx} of {self.tensor_id} unavailable "
                                   "after recompute (tile cache too small?)")
            # evicted or never planned: recompute on demand; parent misses
            # inside the evaluation are handled the same way, so any cache
            # budget only costs recomputation
            self._evaluate_chunk([idx])
            return self._host_tile(idx, _retry=False)
        if isinstance(t, np.ndarray):
            t = torch.from_numpy(t).to(self.device)
        return t

    def _assemble_stack_device(self, boxes):
        """The regions of `boxes` (one shape) assembled from the device cache
        and stacked, or None unless every overlapping window has a slot."""
        if self.device_cache is None:
            return None
        geo = _traced_geometry(self.output_window, boxes, self.device_cache.slot)
        if geo is None:
            return None
        slots, offs, valid, _ = geo
        return assemble_from_atlas(self.device_cache._atlas, slots, offs, valid,
                                   tuple(b - a for a, b in boxes[0]))

    def _assemble(self, ranges) -> torch.Tensor:
        shape = tuple(b - a for a, b in ranges)
        out = torch.zeros(shape, dtype=torch.float32, device=self.device)
        idxs = sorted(self.output_window.windows_overlapping(ranges))
        if self.device_cache is not None:
            # one gather for every window that only the device cache holds
            pairs = [(i, self.device_cache.slot(i)) for i in idxs
                     if not self.tile_store.contains(self.tensor_id, i)]
            pairs = [(i, st) for i, st in pairs if st is not None]
            if pairs:
                self._store_rows([i for i, _ in pairs],
                                 self.device_cache.fetch_rows([st for _, st in pairs]))
        for idx in idxs:
            t = self._host_tile(idx)
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
    windows that several roots need land in the same stage batches.  Each
    device cache first grows to the plan's working set (the windows the
    plan touches, plus 8), so planned windows are not evicted before the
    stage that consumes them runs."""
    need: dict = {}
    touched: dict = {}
    roots = []
    for tensor, ranges_list in requests:
        idxs = set()
        for ranges in ranges_list:
            idxs |= set(tensor.output_window.windows_overlapping(ranges))
        tensor._collect_needed(idxs, need, touched)
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
        tt = touched.get(id(t))
        if tt and t.device_cache is not None:
            t.device_cache.grow_to(len(tt) + 8, tuple(t.output_window.size))
        n = need.get(id(t))
        if n:
            t._evaluate_windows(sorted(n))
