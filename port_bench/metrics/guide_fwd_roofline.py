"""The guide model's forwards (the guided latent stage's AutoGuidance guide)
in the profiled window: their roofline time over the device time of the
kernels launched inside them, in percent."""


def read(run):
    return run["roofline"].get("guide")
