"""Mean tile queries per ``get_many`` call of the coalescer's worker in the
window (serving layer)."""


def read(run):
    spans = run["spans"]
    return sum(n for _, _, n in spans) / len(spans) if spans else None
