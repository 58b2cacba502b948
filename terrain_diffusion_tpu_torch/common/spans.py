"""Spans and stage times of the serving path.

``span(*parts)`` opens a ``torch.profiler.record_function`` range named
``td.<parts joined by dots>`` (``td.get_many``, ``td.plan``,
``td.fwd.base.4.64.64``) while a profiler records on the calling thread, and
otherwise returns one shared null context: no name is built and no range
object is made.  The profiler records only the thread that started it, so
the ranges of the pipeline's worker appear in a profile started on that
thread (``WorldPipeline.profile`` around a call made there; when serving,
a profiler started on the coalescer's worker thread).

``StageClock`` keeps a world's ``stage_timings`` ({stage: [calls,
seconds]}); see ``StageClock.timed``.
"""
from __future__ import annotations

import collections
import contextlib
import time

import torch

PREFIX = "td."
_OFF = contextlib.nullcontext()


def span(*parts):
    """A profiler range ``td.<parts>`` if a profiler records this thread,
    else a null context."""
    if not torch.autograd._profiler_enabled():
        return _OFF
    return torch.profiler.record_function(PREFIX + ".".join(map(str, parts)))


class StageClock:
    """Calls and seconds of each stage of one world, into ``timings``.

    On the CPU a stage's seconds are its host wall time.  On a card nothing
    waits for the device: a CUDA event is recorded on the device's current
    stream before the stage queues its work and another after, and the
    seconds are ``start.elapsed_time(end)``, added by ``settle``.  That is
    the stage's span on the device, from the point the device reaches it
    (the end of the work queued before it, or the moment the host reached
    the stage if the device was idle) to the end of its last queued work,
    idle gaps between its launches included.  The events come from a pool
    and go back to it once read."""

    def __init__(self, timings: dict, device):
        self.timings = timings
        self.device = torch.device(device)
        self._pending = collections.deque()  # (stage, start, end), in recording order
        self._pool = []

    def _event(self):
        return self._pool.pop() if self._pool else torch.cuda.Event(enable_timing=True)

    def _add(self, stage: str, seconds: float, verbose: bool):
        self.timings[stage][1] += seconds
        if verbose:
            print(f"[{stage}] {seconds * 1000:.1f} ms")

    def timed(self, stage: str, fn, verbose: bool = False):
        """``fn()`` as one call of ``stage``, under a ``td.<stage>`` range.
        The call is counted at once; its seconds, on a card, once its end
        event has completed: by the next ``settle``, or at a later call that
        finds it complete (so callers that never settle hold only the events
        still in flight)."""
        self.timings.setdefault(stage, [0, 0.0])[0] += 1
        with span(stage):
            if self.device.type != "cuda":
                t0 = time.perf_counter()
                out = fn()
                self._add(stage, time.perf_counter() - t0, verbose)
                return out
            self.settle(verbose, wait=False)
            stream = torch.cuda.current_stream(self.device)
            start, end = self._event(), self._event()
            start.record(stream)
            out = fn()
            end.record(stream)
            self._pending.append((stage, start, end))
            return out

    def settle(self, verbose: bool = False, wait: bool = True):
        """Add the seconds of the stages timed so far; without ``wait``, only
        of those whose end event has completed.  Meant, with ``wait``, for
        the end of a call that has waited for its results on the host: the
        end events recorded before that wait have then completed, and only
        those recorded after it are waited for here, behind no other work."""
        while self._pending:
            stage, start, end = self._pending[0]
            if not wait and not end.query():
                return
            end.synchronize()
            self._pending.popleft()
            self._add(stage, start.elapsed_time(end) / 1e3, verbose)
            self._pool += (start, end)
