"""Tiles completed over the whole drained window (host clock)."""


def read(run):
    return run["window"]["tiles_per_s"] if run["window"]["tiles"] else None
