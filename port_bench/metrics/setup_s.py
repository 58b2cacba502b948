"""From process start to the first request of the window: imports, the kernel
library loaded (built in a checkout's first run), weights made, the world
bound, the server up and the cell's shapes warmed (host clock)."""


def read(run):
    return run["setup_s"]
