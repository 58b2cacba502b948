"""Cross-request coalescing for concurrent serving.

Counterpart of ``terrain_diffusion_tpu.serving.coalesce``.  Handler threads
enqueue jobs and block on their result, while one pipeline-owner worker
thread drains the queue and serves all pending terrain queries with ONE
``WorldPipeline.get_many`` call: the runtime planner merges their missing
windows into shared stage batches, so N concurrent tile requests run the
same few large stage batches one request would.

Concurrency contract: the pipeline (tile store, stage tensors, seed) is
only ever touched by the worker thread, so the single-threaded-pipeline
invariant the tile store relies on still holds.  Mutating jobs (seed
change, cache changes) run solo, between batches; ordering across
*concurrent* clients is unspecified, while each client's own request order
is preserved by its blocking round trip.

Per-request seeds are part of the terrain job (``seed=``), NOT a separate
mutator: the worker groups a drained batch by requested seed and switches
the world once per group, so a client asking for ``?seed=X`` always gets
seed-X terrain even when another client changes the seed concurrently.
A job may carry several boxes (``get_terrain_boxes``): they are served
under one seed in one batch, which the Minecraft API's padded-elevation +
climate pairs need to stay mutually consistent.
"""
from __future__ import annotations

import queue
import threading


class _Job:
    __slots__ = ("kind", "payload", "event", "result", "error")

    def __init__(self, kind: str, payload):
        self.kind = kind
        self.payload = payload
        self.event = threading.Event()
        self.result = None
        self.error = None

    def finish(self, result=None, error=None):
        self.result = result
        self.error = error
        self.event.set()

    def wait(self):
        self.event.wait()
        if self.error is not None:
            raise self.error
        return self.result


class RequestCoalescer:
    """Single pipeline-owner worker with cross-request terrain batching.

    - ``get_terrain(i1, j1, i2, j2, with_climate, pack_wire, seed)`` blocks
      the calling thread until its tile is composed; concurrent calls
      coalesce.  ``get_terrain_boxes`` submits several boxes as ONE atomic
      job (list result).
    - ``run(fn)`` submits an arbitrary pipeline-mutating callable
      ``fn(world) -> result`` executed solo on the worker thread (seed
      changes, custom conditioning, stats reads).
    - ``max_batch`` caps how many jobs coalesce per pass (the planner
      still chunks stage batches to the pipeline's buckets; this only
      bounds composition latency for the first client).
    """

    def __init__(self, world, max_batch: int = 16):
        self.world = world
        self.max_batch = int(max_batch)
        self._queue: "queue.Queue[_Job]" = queue.Queue()
        self._closed = False
        self._lifecycle = threading.Lock()  # serializes submit vs close
        self._thread = threading.Thread(
            target=self._loop, name="pipeline-coalescer", daemon=True)
        self._thread.start()

    # ------------------------------------------------------------------
    # Client surface (any thread)
    # ------------------------------------------------------------------
    def get_terrain(self, i1: int, j1: int, i2: int, j2: int,
                    with_climate: bool = True, pack_wire: bool = False,
                    seed: int | None = None) -> dict:
        return self.get_terrain_boxes([(i1, j1, i2, j2)], with_climate,
                                      pack_wire, seed)[0]

    def get_terrain_boxes(self, boxes, with_climate: bool = True,
                          pack_wire: bool = False,
                          seed: int | None = None) -> list:
        """Several boxes as ONE job: served together, under one seed."""
        boxes = tuple(tuple(int(c) for c in b) for b in boxes)
        job = _Job("terrain", (boxes, bool(with_climate), bool(pack_wire),
                               None if seed is None else int(seed)))
        self._submit(job)
        return job.wait()

    def run(self, fn):
        """Execute ``fn(world)`` solo on the worker thread; returns its
        result (exceptions re-raised in the caller)."""
        job = _Job("call", fn)
        self._submit(job)
        return job.wait()

    def _submit(self, job):
        # the check and the put must be atomic wrt close(): a job enqueued
        # after the stop job would never be drained and its wait() would
        # hang the handler thread forever
        with self._lifecycle:
            if self._closed:
                raise RuntimeError("RequestCoalescer is closed")
            self._queue.put(job)

    def close(self, timeout: float = 60.0) -> bool:
        """Stop the worker; returns True when it actually exited.  A False
        return means a generation pass is still running — the caller must
        NOT tear down the underlying pipeline (a closed tile store under a
        live worker corrupts in-flight requests)."""
        with self._lifecycle:
            if not self._closed:
                self._closed = True
                self._queue.put(_Job("stop", None))
        self._thread.join(timeout=timeout)
        return not self._thread.is_alive()

    # ------------------------------------------------------------------
    # Worker (owns the pipeline)
    # ------------------------------------------------------------------
    def _loop(self):
        while True:
            job = self._queue.get()
            batch = [job]
            # Drain whatever else is already queued (no waiting): jobs that
            # arrived while the previous batch was generating coalesce now.
            while len(batch) < self.max_batch:
                try:
                    batch.append(self._queue.get_nowait())
                except queue.Empty:
                    break
            try:
                if self._process(batch):  # a stop job was drained
                    return
            except BaseException as e:  # noqa: BLE001 — worker must not
                # die silently: blocked clients would hang forever
                err = RuntimeError(f"coalescer worker died: {e!r}")
                for j in batch:
                    if not j.event.is_set():
                        j.finish(error=err)
                with self._lifecycle:
                    self._closed = True
                while True:  # unblock anything already queued
                    try:
                        self._queue.get_nowait().finish(error=err)
                    except queue.Empty:
                        break
                raise

    def _process(self, batch) -> bool:
        """Run one drained batch; returns True when a stop job was seen
        (AFTER serving every other job drained alongside it — they were
        submitted before close())."""
        stop = False
        terrain_jobs = []
        # Mutating jobs first, in arrival order, each solo …
        for job in batch:
            if job.kind == "terrain":
                terrain_jobs.append(job)
                continue
            if job.kind == "stop":
                stop = True
                job.finish()
                continue
            try:
                job.finish(result=job.payload(self.world))
            except Exception as e:  # noqa: BLE001 — reraised in the caller
                job.finish(error=e)
        if not terrain_jobs:
            return stop
        # … then terrain, grouped by requested seed: seedless jobs first
        # (current world seed), then each explicit seed in arrival order.
        groups: dict = {}
        for j in terrain_jobs:
            groups.setdefault(j.payload[3], []).append(j)
        order = list(groups)
        if None in groups:
            order.remove(None)
            order.insert(0, None)
        for seed_key in order:
            jobs = groups[seed_key]
            if seed_key is not None:
                try:
                    if self.world.change_seed(seed_key):
                        print(f"World seed changed to: {self.world.seed}")
                except Exception as e:  # noqa: BLE001
                    for j in jobs:
                        j.finish(error=e)
                    continue
            self._serve(jobs)
        return stop

    def _serve(self, jobs):
        """One coalesced generation + composition pass over the jobs'
        boxes (get_many); falls back to per-job gets so one bad query cannot
        fail its batchmates."""
        parts: dict = {}
        for j in jobs:
            parts.setdefault((j.payload[1], j.payload[2]), []).append(j)
        if len(parts) > 1:
            # mixed climate/wire flags: one union generation pass up front
            # so the per-partition get_many calls below share stage batches
            # (get_many prefetches internally, so a single partition needs
            # no extra pass)
            all_boxes = [b for j in jobs for b in j.payload[0]]
            any_climate = any(j.payload[1] for j in jobs)
            try:
                self.world.prefetch(all_boxes, with_climate=any_climate)
            except Exception as e:  # noqa: BLE001
                for j in jobs:
                    j.finish(error=e)
                return
        for (wc, pw), js in parts.items():
            boxes = [b for j in js for b in j.payload[0]]
            try:
                results = self.world.get_many(boxes, with_climate=wc,
                                              pack_wire=pw)
            except Exception:  # noqa: BLE001 — isolate per job below
                results = None
            if results is not None:
                k = 0
                for j in js:
                    n = len(j.payload[0])
                    j.finish(result=list(results[k:k + n]))
                    k += n
                continue
            for j in js:
                try:
                    j.finish(result=[
                        self.world.get(*b, with_climate=wc, pack_wire=pw)
                        for b in j.payload[0]])
                except Exception as e:  # noqa: BLE001
                    j.finish(error=e)


class CoalescedPipeline:
    """Thread-safe WorldPipeline facade for concurrent servers.

    ``get()`` coalesces with other in-flight requests; known mutators
    (seed/SNR/conditioning/cache) run solo on the worker thread; everything
    else proxies read-only to the underlying pipeline.  Drop-in for the
    serving handlers — they keep calling the WorldPipeline surface, plus
    ``seed=`` on get/get_boxes for atomic per-request seeds.
    """

    _MUTATORS = ("change_seed", "set_cond_snr", "set_custom_conditioning_import",
                 "rebuild", "empty_cache", "warmup", "prefetch")

    def __init__(self, world, max_batch: int = 16):
        self._world = world
        self._coalescer = RequestCoalescer(world, max_batch=max_batch)

    def get(self, i1, j1, i2, j2, with_climate: bool = True,
            pack_wire: bool = False, seed: int | None = None) -> dict:
        return self._coalescer.get_terrain(i1, j1, i2, j2, with_climate,
                                           pack_wire, seed)

    def get_boxes(self, boxes, with_climate: bool = True,
                  pack_wire: bool = False, seed: int | None = None) -> list:
        """Several boxes as one atomic job (one seed, one batch)."""
        return self._coalescer.get_terrain_boxes(boxes, with_climate,
                                                 pack_wire, seed)

    def get_many(self, queries, with_climate: bool = True,
                 pack_wire: bool = False) -> list:
        return self._coalescer.run(
            lambda w: w.get_many(queries, with_climate=with_climate,
                                 pack_wire=pack_wire))

    def close(self):
        if self._coalescer.close():
            self._world.close()
        else:
            # a generation pass is still running on the worker; closing the
            # tile store under it would corrupt in-flight requests — leak
            # the pipeline instead (the daemon thread dies with the process)
            print("[CoalescedPipeline] worker still busy after close "
                  "timeout; leaving the pipeline open")

    def __getattr__(self, name):
        if name in self._MUTATORS:
            method = getattr(self._world, name)

            def solo(*args, **kwargs):
                return self._coalescer.run(lambda _w: method(*args, **kwargs))

            return solo
        return getattr(self._world, name)
