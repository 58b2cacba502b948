"""HTTP clients of ``GET /terrain`` and the window's statistics.

Closed loop (``drive``): each client thread takes the next tile of the mix
(one shared iterator), sends it with plain ``urllib``, reads the whole body
and only then takes the next.  Open loop (``drive_open``): each request is
due at its arrival time and is sent then by a free client thread, or as soon
as one is free; its latency counts from the time it was due.  Either way, no
request is sent once the deadline has passed; the window ends when the last
request in flight at the deadline has completed, so a coalesced batch is
never cut in two.
"""
from __future__ import annotations

import queue
import threading
import time
import urllib.error
import urllib.request

import numpy as np


class Record:
    __slots__ = ("k", "box", "t0", "t1", "ok", "body", "error")

    def __init__(self, k, box):
        self.k, self.box = k, box
        self.t0 = self.t1 = None
        self.ok, self.body, self.error = False, None, None


def fetch(port: int, box, timeout: float = 600.0) -> bytes:
    i1, j1, i2, j2 = box
    url = f"http://127.0.0.1:{port}/terrain?i1={i1}&j1={j1}&i2={i2}&j2={j2}"
    with urllib.request.urlopen(url, timeout=timeout) as r:
        if r.status != 200:
            raise RuntimeError(f"status {r.status}")
        h, w = int(r.headers["X-Height"]), int(r.headers["X-Width"])
        body = r.read()
    if (h, w) != (i2 - i1, j2 - j1) or len(body) != h * w * 18:
        raise RuntimeError(f"{h}x{w} tile of {len(body)} bytes for {box}")
    return body


def drive(port: int, tiles, clients: int, deadline: float | None = None,
          keep_bodies: bool = True, until=None) -> list:
    """Run ``clients`` closed-loop clients over the iterable ``tiles`` until it
    is exhausted or, with ``deadline`` (a ``time.perf_counter`` time), until
    the deadline, and with ``until`` until it returns True; returns the
    records in send order."""
    it = iter(tiles)
    lock = threading.Lock()
    records = []

    def client():
        while True:
            with lock:
                if deadline is not None and time.perf_counter() >= deadline:
                    return
                if until is not None and until():
                    return
                box = next(it, None)
                if box is None:
                    return
                rec = Record(len(records), box)
                records.append(rec)
                rec.t0 = time.perf_counter()
            try:
                body = fetch(port, box)
                rec.ok = True
                if keep_bodies:
                    rec.body = body
            except (OSError, RuntimeError, urllib.error.URLError) as e:
                rec.error = repr(e)
            rec.t1 = time.perf_counter()

    threads = [threading.Thread(target=client, name=f"client{i}", daemon=True)
               for i in range(clients)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=900)
        if t.is_alive():
            raise RuntimeError("a client did not finish within 900 s")
    return records


def drive_open(port: int, tiles, arrivals, clients: int, t_start: float, deadline: float,
               until=None) -> list:
    """Send request ``k`` of the iterable ``tiles`` at ``t_start`` plus the
    ``k``-th of ``arrivals`` (seconds), by ``clients`` client threads, until
    the deadline (and with ``until`` until it returns True); returns the
    records in send order, each timed from when it was due."""
    due = queue.Queue()
    records = []

    def dispatch():
        for box, offset in zip(tiles, arrivals):
            t = t_start + offset
            if t >= deadline or (until is not None and until()):
                break
            wait = t - time.perf_counter()
            if wait > 0:
                time.sleep(wait)
            rec = Record(len(records), box)
            rec.t0 = t
            records.append(rec)
            due.put(rec)
        for _ in range(clients):
            due.put(None)

    def client():
        while (rec := due.get()) is not None:
            try:
                rec.body = fetch(port, rec.box)
                rec.ok = True
            except (OSError, RuntimeError, urllib.error.URLError) as e:
                rec.error = repr(e)
            rec.t1 = time.perf_counter()

    threads = [threading.Thread(target=dispatch, name="arrivals", daemon=True)]
    threads += [threading.Thread(target=client, name=f"client{i}", daemon=True)
                for i in range(clients)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=max(900.0, deadline - time.perf_counter() + 900.0))
        if t.is_alive():
            raise RuntimeError("a client did not finish within 900 s of the deadline")
    return records


def run_window(port: int, plan, t_start: float, deadline: float, until=None) -> list:
    """The window's requests of the traffic ``plan`` (``traffic.Plan``),
    closed or open loop as the mix says."""
    arrivals = plan.arrivals()
    if arrivals is None:
        return drive(port, plan.tiles(), plan.clients, deadline=deadline, until=until)
    return drive_open(port, plan.tiles(), arrivals, plan.clients, t_start, deadline, until)


def percentile(xs, q: float) -> float:
    """numpy's linear percentile (``evaluation/latency.py::_stats``)."""
    return float(np.percentile(np.asarray(xs, np.float64), q))


def window_stats(records: list, t_start: float, t_stop: float | None = None) -> dict:
    """Tiles completed over the drained window, the latencies and the
    failures; the window runs from ``t_start`` to the last completion, or to
    ``t_stop`` with the requests completed by then."""
    if t_stop is not None:
        records = [r for r in records if r.t1 <= t_stop]
    done = [r for r in records if r.ok]
    t_end = t_stop if t_stop is not None else max((r.t1 for r in records), default=t_start)
    lat_ms = [(r.t1 - r.t0) * 1e3 for r in done]
    return {"attempted": len(records), "failed": len(records) - len(done),
            "tiles": len(done), "t_start": t_start, "t_end": t_end,
            "window_s": t_end - t_start,
            "tiles_per_s": len(done) / (t_end - t_start) if t_end > t_start else 0.0,
            "latency_ms": lat_ms,
            "p50_ms": percentile(lat_ms, 50) if lat_ms else None,
            "p95_ms": percentile(lat_ms, 95) if lat_ms else None}
