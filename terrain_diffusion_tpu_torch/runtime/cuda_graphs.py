"""CUDA graphs of the stage models' forwards.

On a card a stage forward of the serving path is hundreds of small kernels,
and issuing each from Python takes longer than the kernel runs: the device
waits on the host.  ``ForwardGraphs`` replays the whole forward as one CUDA
graph instead, one graph per model and input signature (the shapes and
types of ``x``, of the noise labels and of each conditioning tensor; the
stage batch buckets bound them):

- a signature's first forward runs eagerly;
- its second captures the graph, on one side stream that the cache keeps,
  into one memory pool that all its graphs share (the allocator's unused
  cached blocks released first), then replays it;
- every later forward copies its inputs into the graph's static inputs,
  replays, and returns a copy of the static output, which the next replay
  of a graph in the shared pool may overwrite.

The static inputs of a signature are views of one buffer per model and
input, sized for the largest batch the model's stage sends (``reserve``),
so the buckets of a model share them.  They are made at the model's first
forward, eager as it is: a forward's memory peak then holds them whether
the forward runs eagerly or is captured later, so the peak does not depend
on which signatures recur first.  A capture runs the model's ``forward``
directly, in the capturing thread's own capture mode, so no forward hook
fires and other threads' CUDA work neither breaks it nor is broken by it.
The kernels' ``launches`` counters (``ops/cuda_lib.py``) count a replay's
captured launches as an eager forward counts them.

The caller decides where graphs engage (``WorldPipeline._forward``: a card,
no mesh, no autograd); the cache serves one thread at a time, as the world
that owns it does, and ``clear`` drops every graph (they hold the weights'
addresses).
"""
from __future__ import annotations

import torch

from terrain_diffusion_tpu_torch.ops import cuda_lib


def signature(t: torch.Tensor) -> tuple:
    """A tensor's part of a graph key: its shape and type."""
    return tuple(t.shape), t.dtype


def graph_key(model, x, noise_labels, cond) -> tuple:
    """The cache key of ``model(x, noise_labels, cond)``: the model and the
    shapes and types of every input, in effect the batch bucket."""
    return (id(model), signature(x), signature(noise_labels),
            tuple(signature(c) for c in cond))


class _Graph:
    __slots__ = ("graph", "inputs", "out", "launches")

    def __init__(self, graph, inputs, out, launches):
        self.graph = graph
        self.inputs = inputs      # the static inputs: x, noise labels, *cond
        self.out = out            # the static output
        self.launches = launches  # the kernels' launches captured, by wrapper and type


class ForwardGraphs:
    """One CUDA graph per stage model and input signature; see the module."""

    def __init__(self):
        self.clear()

    def reserve(self, model, rows: int):
        """The static inputs of ``model`` hold ``rows`` rows (at least)."""
        self._rows[id(model)] = max(self._rows.get(id(model), 0), int(rows))

    def clear(self):
        """Drop every graph, static buffer and reservation."""
        self._rows = {}      # id(model) -> the largest batch its stage sends
        self._seen = set()   # keys whose first, eager forward has run
        self._graphs = {}    # key -> _Graph
        self._buffers = {}   # (id(model), row signatures) -> static input buffers
        self._pool = self._stream = None

    def __call__(self, model, x, noise_labels, cond, counts: dict):
        """``model.forward(x, noise_labels, cond)``: eagerly at a signature's
        first call, else replayed from its graph (captured at the second).
        ``counts`` takes the ``captures`` and ``replays``."""
        key = graph_key(model, x, noise_labels, cond)
        g = self._graphs.get(key)
        if g is None:
            if key not in self._seen:
                self._seen.add(key)
                self._static_inputs(model, [x, noise_labels, *cond])
                return model.forward(x, noise_labels, cond)
            g = self._capture(model, x, noise_labels, cond)
            if g is None:
                return model.forward(x, noise_labels, cond)
            self._graphs[key] = g
            counts["captures"] += 1
        for static, t in zip(g.inputs, (x, noise_labels, *cond)):
            static.copy_(t)
        g.graph.replay()
        cuda_lib.add_launches(g.launches)
        counts["replays"] += 1
        return g.out.clone()

    def _static_inputs(self, model, inputs):
        """Views of the model's static buffers for ``inputs`` (every one a
        batch of B rows), or None for a batch past the buffers' rows."""
        B = inputs[0].shape[0]
        bkey = (id(model),) + tuple((tuple(t.shape[1:]), t.dtype) for t in inputs)
        bufs = self._buffers.get(bkey)
        if bufs is None:
            rows = max(self._rows.get(id(model), 0), B)
            bufs = self._buffers[bkey] = [
                torch.empty((rows, *t.shape[1:]), dtype=t.dtype, device=t.device)
                for t in inputs]
        if bufs[0].shape[0] < B:
            return None
        return [b[:B] for b in bufs]

    def _capture(self, model, x, noise_labels, cond) -> _Graph | None:
        inputs = self._static_inputs(model, [x, noise_labels, *cond])
        if inputs is None:
            return None
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
            self._stream = torch.cuda.Stream(x.device)
        # a capture cannot release cached blocks when its pool runs short (no
        # cudaFree while capturing), as an eager forward does: release the
        # unused ones first
        torch.cuda.empty_cache()
        graph = torch.cuda.CUDAGraph()
        before = cuda_lib.launch_counts()
        with torch.cuda.stream(self._stream):
            graph.capture_begin(pool=self._pool, capture_error_mode="thread_local")
            try:
                out = model.forward(inputs[0], inputs[1], inputs[2:])
            finally:
                graph.capture_end()
        launches = cuda_lib.launches_since(before)
        cuda_lib.add_launches(launches, -1)  # captured, not run: the replays count them
        return _Graph(graph, inputs, out, launches)
