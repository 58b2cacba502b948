"""Per tile served, the window's increase of the world's ``stage_timings`` of
``compose``, in ms."""


def read(run):
    tiles = run["window"]["tiles"]
    if not tiles or "compose" not in run["stage_delta"]:
        return None
    return 1e3 * run["stage_delta"]["compose"] / tiles
