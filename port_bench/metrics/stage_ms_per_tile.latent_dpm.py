"""Per tile served, the window's increase of the world's ``stage_timings`` of
``latent_dpm`` (the guided world's latent stage: every DPM-Solver++ step of
a window, both models' forwards), in ms."""


def read(run):
    tiles = run["window"]["tiles"]
    if not tiles or "latent_dpm" not in run["stage_delta"]:
        return None
    return 1e3 * run["stage_delta"]["latent_dpm"] / tiles
