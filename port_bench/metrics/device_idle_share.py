"""1 minus the union of device activity (kernels, copies, sets) over the
profiled window of ``torch.profiler``, in percent."""


def read(run):
    tr = run["trace"]
    return None if tr is None else 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
