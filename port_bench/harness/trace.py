"""Spans of the traced run (``--trace 1``) and the reduction of the device trace.

Everything is set from the benchmark's side, around the calls into the
port's layers, on the one pipeline worker thread that the coalescer runs:

- ``get_many`` of the world the coalescer holds is wrapped: a host-clock
  span and the query count of every call, and a ``record_function`` range;
- the world's ``_timed`` stage spans get a ``record_function`` range each
  (coarse, latent_init, latent_step, decoder, compose, fetch, prefetch);
- each stage model gets forward hooks: the rows it ran, and a
  ``record_function`` range named by the model, its batch and map size.

``torch.profiler`` (CPU and CUDA) runs on the worker thread over a part that
follows the measured window under the same load, started and stopped between
two ``get_many`` calls.  ``reduce_trace`` reads its Chrome trace: the union of device
activity (busy time), the device time of the kernels launched inside each
model range, the kernels that took the most time, and the longest idle gaps,
each labelled by the innermost range the worker was in when it began.
"""
from __future__ import annotations

import bisect
import collections
import json
import os
import tempfile
import threading
import time

import torch

MODEL_STAGES = {"coarse": "coarse_model", "base": "base_model", "decoder": "decoder_model"}
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


class Tracer:
    def __init__(self, world, profile_from: float, profile_to: float, snapshot):
        """Instrument ``world`` (a ``WorldPipeline``); the profiler covers the
        first ``get_many`` call at or after ``profile_from`` to the first at
        or after ``profile_to`` (``time.perf_counter`` times).  When it
        starts, ``t_prof`` takes the time and ``at_prof`` what ``snapshot()``
        returns, with the models' rows and forwards so far."""
        self.world = world
        self.snapshot = snapshot
        self.t_prof = self.at_prof = None
        self.spans = []            # (t0, t1, queries) of every get_many
        self.rows = collections.Counter()    # stage model -> rows run
        self.forwards = collections.Counter()
        self.profile_from, self.profile_to = profile_from, profile_to
        self.prof = None
        self.profiled = False
        self._ranges = []
        self._lock = threading.Lock()
        self._orig_get_many = world.get_many
        self._orig_timed = world._timed
        world.get_many = self._get_many
        world._timed = self._timed
        self._hooks = []
        for stage, attr in MODEL_STAGES.items():
            model = getattr(world, attr)
            self._hooks.append(model.register_forward_pre_hook(self._pre(stage)))
            self._hooks.append(model.register_forward_hook(self._post))

    def _pre(self, stage):
        def hook(_module, args):
            x = args[0]
            self.rows[stage] += x.shape[0]
            self.forwards[stage] += 1
            rf = torch.profiler.record_function(
                f"bench.fwd.{stage}.{x.shape[0]}.{x.shape[1]}.{x.shape[2]}")
            rf.__enter__()
            self._ranges.append(rf)
        return hook

    def _post(self, _module, _args, _out):
        self._ranges.pop().__exit__(None, None, None)

    def _timed(self, stage, fn):
        with torch.profiler.record_function(f"bench.stage.{stage}"):
            return self._orig_timed(stage, fn)

    def _get_many(self, queries, *args, **kwargs):
        t0 = time.perf_counter()
        if self.prof is None and not self.profiled and t0 >= self.profile_from:
            self.start()
        elif self.prof is not None and t0 >= self.profile_to:
            self.stop()
        with torch.profiler.record_function("bench.get_many"):
            out = self._orig_get_many(queries, *args, **kwargs)
        with self._lock:
            self.spans.append((t0, time.perf_counter(), len(queries)))
        return out

    def start(self):
        self.t_prof = time.perf_counter()
        self.at_prof = (*self.snapshot(), dict(self.rows), dict(self.forwards))
        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self.prof = torch.profiler.profile(activities=acts)
        self.prof.__enter__()
        with torch.profiler.record_function("bench.window_start"):
            pass

    def stop(self):
        """Stop the profiler; call on the thread that started it."""
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        with torch.profiler.record_function("bench.window_end"):
            pass
        self.prof.__exit__(None, None, None)
        self.profiled = True

    def close(self):
        for h in self._hooks:
            h.remove()
        self.world.get_many = self._orig_get_many
        self.world._timed = self._orig_timed

    def chrome_trace(self) -> dict | None:
        """The profiled window's Chrome trace, read back from a temporary file."""
        if not self.profiled:
            return None
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            with open(path, encoding="utf-8") as f:
                return json.load(f)
        finally:
            os.unlink(path)


def _union(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def reduce_trace(trace: dict) -> dict | None:
    """{busy_s, window_s, device_ops, idle_gaps, model_device_s} of the
    profiled window, or None where the trace holds no device activity (the
    profiler saw no card)."""
    events = [e for e in trace.get("traceEvents", []) if e.get("ph") == "X"]
    marks = {e["name"]: e["ts"] for e in events if e["name"] in ("bench.window_start",
                                                                  "bench.window_end")}
    if len(marks) != 2:
        return None
    w0, w1 = marks["bench.window_start"], marks["bench.window_end"]
    dev = [e for e in events if e.get("cat") in DEVICE_CATS
           and e["ts"] < w1 and e["ts"] + e["dur"] > w0]
    if not dev:
        return None
    busy = _union((max(e["ts"], w0), min(e["ts"] + e["dur"], w1)) for e in dev)
    busy_us = sum(b - a for a, b in busy)
    op_time = collections.Counter()
    for e in dev:
        op_time[e["name"]] += e["dur"] * 1e-6
    # host ranges of the worker: the stage spans, forwards and get_many calls
    ranges = [e for e in events if e.get("cat") == "user_annotation"
              and e["name"].startswith("bench.") and "window" not in e["name"]]
    gaps = [(a1, b0) for (_, a1), (b0, _) in zip(busy, busy[1:])]
    if busy:
        gaps = [(w0, busy[0][0])] + gaps + [(busy[-1][1], w1)]

    def label(t):
        inner = [r for r in ranges if r["ts"] <= t < r["ts"] + r["dur"]]
        if not inner:
            return "outside get_many (HTTP, coalescer queue)"
        return min(inner, key=lambda r: r["dur"])["name"][len("bench."):]

    gaps = [(s, label(a)) for s, a in sorted(((b - a) * 1e-6, a) for a, b in gaps
                                             if b > a)[::-1][:10]]
    # device time of the kernels launched inside each forward range
    launch = {}
    for e in events:
        if e.get("cat") == "cuda_runtime" and "correlation" in e.get("args", {}):
            launch[e["args"]["correlation"]] = (e["ts"], e.get("tid"))
    launched = sorted((launch[k["args"]["correlation"]], k["dur"] * 1e-6) for k in events
                      if k.get("cat") == "kernel" and k.get("args", {}).get("correlation") in launch)
    starts = [ts for (ts, _tid), _d in launched]
    model_device_s = collections.defaultdict(lambda: [0.0, []])
    for r in ranges:
        if r["name"].startswith("bench.fwd."):
            _, _, stage, n, h, _w = r["name"].split(".")
            lo = bisect.bisect_left(starts, r["ts"])
            hi = bisect.bisect_right(starts, r["ts"] + r["dur"])
            model_device_s[stage][0] += sum(d for (_ts, tid), d in launched[lo:hi]
                                            if tid == r.get("tid"))
            model_device_s[stage][1].append((int(n), int(h)))
    return {"busy_s": busy_us * 1e-6, "window_s": (w1 - w0) * 1e-6,
            "device_ops": [[n, s] for n, s in op_time.most_common(10)],
            "idle_gaps": [[lab, s] for s, lab in gaps],
            "model_device_s": dict(model_device_s)}
