"""Per tile served, the window's increase of the world's ``stage_timings`` of
the world kind's model stages (``run["model_stages"]``; for ``t2``: coarse,
latent_init, latent_step, decoder), in ms.  ``prefetch`` holds them and is
left out."""


def read(run):
    tiles = run["window"]["tiles"]
    return (1e3 * sum(run["stage_delta"].get(s, 0.0) for s in run["model_stages"]) / tiles
            if tiles else None)
