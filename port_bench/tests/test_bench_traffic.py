"""The traffic generator: deterministic per seed, never a fresh tile twice,
the same window geometry for every seed (each mix starts on the alignment
grid), returns to served tiles and open-loop arrivals as a mix's data say."""
import glob
import itertools
import os

import numpy as np
import pytest

from conftest import BENCH_DIR
from harness import registry, traffic

MIXES = sorted(os.path.basename(p)[:-5] for p in glob.glob(os.path.join(BENCH_DIR, "traffic",
                                                                       "*.json")))


def _take(mix, seed, n=400):
    p = traffic.plan(seed, registry.traffic(mix))
    return p, list(itertools.islice(p.tiles(), n))


@pytest.mark.parametrize("mix", MIXES)
def test_deterministic_per_seed_and_no_tile_twice(mix):
    p1, t1 = _take(mix, 2 ** 31 + 5)
    p2, t2 = _take(mix, 2 ** 31 + 5)
    assert t1 == t2 and p1.warm == p2.warm
    _, t3 = _take(mix, 2 ** 31 + 6)
    assert t3 != t1
    all_tiles = p1.warm + t1
    if not registry.traffic(mix).get("revisit"):
        assert len(set(all_tiles)) == len(all_tiles)
    tile = registry.traffic(mix)["tile"]
    assert all(i2 - i1 == tile and j2 - j1 == tile for i1, j1, i2, j2 in all_tiles)


@pytest.mark.parametrize("mix", MIXES)
def test_same_geometry_for_every_seed(mix):
    _, a = _take(mix, 11, 40)
    _, b = _take(mix, 12, 40)
    A = traffic.ALIGN
    assert [((i - a[0][0]) % A, (j - a[0][1]) % A) for i, j, _, _ in a] == \
        [((i - b[0][0]) % A, (j - b[0][1]) % A) for i, j, _, _ in b]
    assert a[0][0] % A == 0 and a[0][1] % A == 0


def test_walk_rows_in_raster_order_and_warm_far_away():
    p, t = _take("walk", 3, 16)
    params = registry.traffic("walk")
    w, tile = params["width"], params["tile"]
    assert [b[1] - t[0][1] for b in t[:w]] == [c * tile for c in range(w)]
    assert t[w][0] - t[0][0] == tile
    assert min(abs(a[1] - b[1]) for a in p.warm for b in t) > 100 * tile


def test_scatter_tiles_share_no_window():
    _, t = _take("scatter", 9, 200)
    cells = {(i1 // traffic.ALIGN, j1 // traffic.ALIGN) for i1, j1, _, _ in t}
    assert len(cells) == len(t)


def test_every_mix_of_the_benchmark_is_tested():
    assert {w["traffic"] for w in registry.benchmark()["workloads"]} <= set(MIXES)
    assert {"walk", "scatter"} <= set(MIXES)


@pytest.mark.parametrize("mix", MIXES)
def test_closed_loop_unless_the_mix_says_open(mix):
    p = traffic.plan(3, registry.traffic(mix))
    assert (p.arrivals() is None) == (registry.traffic(mix).get("arrival", {"kind": "closed"})
                                      ["kind"] == "closed")


def test_revisits_return_to_tiles_sent_at_least_lag_before():
    params = dict(registry.traffic("walk"), revisit=0.5, revisit_lag=6)
    t1 = list(itertools.islice(traffic.plan(2 ** 31 + 7, params).tiles(), 2000))
    assert t1 == list(itertools.islice(traffic.plan(2 ** 31 + 7, params).tiles(), 2000))
    first, back = {}, 0
    for k, box in enumerate(t1):
        if box in first:
            assert k - first[box] >= 6
            back += 1
        else:
            first[box] = k
    assert 0.45 < back / len(t1) < 0.55
    fresh = [b for k, b in enumerate(t1) if first[b] == k]
    plain = list(itertools.islice(traffic.plan(2 ** 31 + 7, registry.traffic("walk")).tiles(),
                                  len(fresh)))
    assert fresh == plain


@pytest.mark.parametrize("gaps", ["even", "poisson"])
def test_open_arrivals_in_bursts_at_the_rate(gaps):
    params = dict(registry.traffic("scatter"),
                  arrival={"kind": "open", "rate": 4.0, "burst": 2, "gaps": gaps})
    a = list(itertools.islice(traffic.plan(11, params).arrivals(), 4000))
    assert a == list(itertools.islice(traffic.plan(11, params).arrivals(), 4000))
    assert a[0] == 0.0 and all(x == y for x, y in zip(a[::2], a[1::2]))
    assert all(y >= x for x, y in zip(a, a[1:]))
    assert abs((len(a) - 2) / a[-1] - 4.0) < (1e-9 if gaps == "even" else 0.3)
    if gaps == "even":
        assert np.allclose(np.diff(a[::2]), 0.5)


def test_an_unknown_arrival_is_refused():
    with pytest.raises(ValueError):
        traffic.plan(1, dict(registry.traffic("walk"), arrival={"kind": "sometimes"}))
