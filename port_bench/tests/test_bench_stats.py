"""The window's rate and tail on synthetic timestamps."""
import numpy as np

from harness import load


def _rec(k, t0, t1, ok=True):
    r = load.Record(k, (0, 0, 1, 1))
    r.t0, r.t1, r.ok = t0, t1, ok
    return r


def test_rate_over_the_drained_window_and_p95_over_all_requests():
    # 4 clients from t=10, requests of 0.5 s; the last one sent before the
    # deadline completes at 12.7: the window is 2.7 s long
    recs = [_rec(k, 10 + 0.5 * (k // 4), 10.5 + 0.5 * (k // 4)) for k in range(16)]
    recs.append(_rec(16, 12.2, 12.7))
    recs.append(_rec(17, 12.2, 12.6, ok=False))
    s = load.window_stats(recs, 10.0)
    assert s["attempted"] == 18 and s["failed"] == 1 and s["tiles"] == 17
    assert np.isclose(s["window_s"], 2.7) and np.isclose(s["tiles_per_s"], 17 / 2.7)
    lat = [500.0] * 17
    lat[-1] = 500.0
    assert np.isclose(s["p95_ms"], np.percentile(lat, 95))


def test_p95_is_numpys_linear_percentile_of_every_latency():
    recs = [_rec(k, 0.0, (k + 1) / 1000.0) for k in range(200)]
    s = load.window_stats(recs, 0.0)
    assert np.isclose(s["p95_ms"], np.percentile(np.arange(1, 201, dtype=float), 95))
    assert np.isclose(s["tiles_per_s"], 200 / 0.2)


def test_a_stop_time_keeps_the_requests_completed_by_then():
    recs = [_rec(k, k * 1.0, k * 1.0 + 0.5) for k in range(10)]
    s = load.window_stats(recs, 0.0, t_stop=5.0)
    assert s["tiles"] == 5 and np.isclose(s["window_s"], 5.0)
