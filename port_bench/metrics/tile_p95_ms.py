"""95th percentile of every request's latency in the window, from the
client's send to the last byte read (host clock)."""


def read(run):
    return run["window"]["p95_ms"]
