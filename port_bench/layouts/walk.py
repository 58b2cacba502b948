"""A viewer walking a straight line across fresh ground: a frontier of
``width`` tiles requested row by row, each row in raster order.  The warm-up
walks ``warm_rows`` rows of the same frontier ``warm_cells`` grid cells away.
Keys: ``tile``, ``width``, ``warm_rows``, ``warm_cells``, ``grid_span``."""
import itertools

from harness.traffic import ALIGN


def _rows(i0, j0, tile, width, rows=None):
    for r in (range(rows) if rows is not None else itertools.count()):
        for c in range(width):
            i, j = i0 + r * tile, j0 + c * tile
            yield (i, j, i + tile, j + tile)


def layout(rng, p):
    tile, width = p["tile"], p["width"]
    i0, j0 = (int(v) * ALIGN for v in rng.integers(-p["grid_span"], p["grid_span"], size=2))
    warm = list(_rows(i0, j0 + p["warm_cells"] * ALIGN, tile, width, p["warm_rows"]))
    return warm, lambda: _rows(i0, j0, tile, width)
