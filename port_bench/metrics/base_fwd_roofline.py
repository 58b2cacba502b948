"""The base model's forwards (latent init and step) in the profiled window:
their roofline time over the device time of the kernels launched inside
them, in percent."""


def read(run):
    return run["roofline"].get("base")
