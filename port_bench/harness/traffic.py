"""The traffic generator: one for every mix, read from the mix's data file
(``port_bench/traffic/<mix>.json``).

Every request is one ``tile`` x ``tile`` box of ``GET /terrain``.  A mix's
keys:

- ``pattern``: where the fresh tiles lie, the layout
  ``port_bench/layouts/<pattern>.py`` found by name (``walk``, ``scatter``),
  with the layout's own keys;
- ``tile``: the side of every box, in pixels; ``clients``: the requests in
  flight at most;
- ``revisit`` (default 0): the share of the window's requests that return to
  a tile the window sent at least ``revisit_lag`` requests before (default
  4 x ``clients``), drawn from the seed; the others are fresh;
- ``arrival`` (default ``{"kind": "closed"}``): ``closed``, each client
  sends its next request once its last has completed; or ``open``
  (``rate``, ``burst``, ``gaps``), bursts of ``burst`` requests (default 1)
  at ``rate`` requests a second on average, spaced evenly (``gaps``
  ``"even"``, the default) or at exponential gaps drawn from the seed
  (``"poisson"``), whether or not the earlier ones have completed.

Locations come from the seed; every layout starts on a grid of ``ALIGN``
pixels, so that every seed asks for the same windows of every stage, in
another place, and set-up warms the cell's shapes far from the window's
ground.  No fresh tile is requested twice.
"""
from __future__ import annotations

import bisect
import itertools

import numpy as np

# the least common multiple, in pixels, of every stage's window stride and
# noise tile (coarse windows: 48 coarse cells of 256 pixels; noise tiles: 64
# coarse cells): a mix started on this grid meets the same window geometry
ALIGN = 49152


class Plan:
    """``warm`` (the set-up's tiles), ``tiles()`` (the window's, an
    iterator), ``clients``, and ``arrivals()``: the send times of an open
    loop, in seconds from the window's start (an iterator), or None."""

    def __init__(self, warm, tiles, clients, arrivals=None):
        self.warm, self._tiles, self.clients, self._arrivals = warm, tiles, clients, arrivals

    def tiles(self):
        return self._tiles()

    def arrivals(self):
        return None if self._arrivals is None else self._arrivals()


def with_revisits(fresh, share: float, lag: int, rng):
    """``fresh`` with a ``share`` of returns to fresh tiles sent ``lag``
    requests or more before, drawn from ``rng``."""
    sent, at = [], []  # the fresh tiles and the request each went out as
    for k in itertools.count():
        n = bisect.bisect_right(at, k - lag)
        if n and rng.random() < share:
            yield sent[int(rng.integers(n))]
            continue
        box = next(fresh, None)
        if box is None:
            return
        sent.append(box)
        at.append(k)
        yield box


def open_arrivals(rate: float, burst: int, gaps: str, rng):
    """Send times of an open loop: bursts of ``burst`` at ``rate`` requests a
    second on average."""
    t = 0.0
    while True:
        for _ in range(burst):
            yield t
        t += rng.exponential(burst / rate) if gaps == "poisson" else burst / rate


def plan(seed: int, params: dict, layout=None) -> Plan:
    """The mix ``params`` from ``seed``; ``layout`` replaces the one found by
    the name in ``pattern``."""
    if layout is None:
        from harness.registry import layout as find

        layout = find(params["pattern"])
    warm, fresh = layout(np.random.default_rng(seed), params)
    share = float(params.get("revisit", 0.0))
    lag = int(params.get("revisit_lag", 4 * params["clients"]))
    tiles = fresh if share == 0 else (
        lambda: with_revisits(iter(fresh()), share, lag, np.random.default_rng([seed, 1])))
    arrival = params.get("arrival", {"kind": "closed"})
    if arrival["kind"] == "closed":
        return Plan(warm, tiles, params["clients"])
    if arrival["kind"] != "open":
        raise ValueError(f"arrival {arrival['kind']!r}: 'closed' or 'open'")
    return Plan(warm, tiles, params["clients"], lambda: open_arrivals(
        float(arrival["rate"]), int(arrival.get("burst", 1)), arrival.get("gaps", "even"),
        np.random.default_rng([seed, 2])))
