"""Every tile at its own cell of the alignment grid, drawn from the seed
without replacement over ``2 * grid_span`` cells a side, so no two requests
share a window of any stage; the first ``warm`` cells warm the server.
Keys: ``tile``, ``warm``, ``grid_span``."""
from harness.traffic import ALIGN


def layout(rng, p):
    span, tile = p["grid_span"], p["tile"]
    side = 2 * span
    cells = rng.permutation(side * side)
    boxes = [((int(c) // side - span) * ALIGN, (int(c) % side - span) * ALIGN) for c in cells]
    boxes = [(i, j, i + tile, j + tile) for i, j in boxes]
    n = p["warm"]
    return boxes[:n], lambda: iter(boxes[n:])
