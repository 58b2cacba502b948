"""The decoder's forwards in the profiled window: their roofline time
(``harness/work.py::roofline_s`` at each forward's batch) over the device
time of the kernels launched inside them, in percent."""


def read(run):
    return run["roofline"].get("decoder")
