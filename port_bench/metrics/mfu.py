"""Useful model FLOPs of the window over its seconds times the type's dense
peak (``harness/work.py``): each stage window the served tiles needed, once,
at its stage's FLOPs a window; bucket padding and repeats are not counted."""


def read(run):
    w = run["window"]
    if not w["tiles"]:
        return None
    return 100.0 * run["useful_flops"] / (w["window_s"] * run["peak_flops"])
