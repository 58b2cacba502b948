"""Share of the window that the single pipeline worker spends inside
``get_many`` (serving layer), in percent."""


def read(run):
    w = run["window"]
    if not run["spans"]:
        return None
    busy = sum(min(t1, w["t_end"]) - max(t0, w["t_start"]) for t0, t1, _ in run["spans"])
    return 100.0 * busy / w["window_s"]
