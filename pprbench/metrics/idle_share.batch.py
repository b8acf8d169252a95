"""idle_share.batch: the share of the traced stretch of a batch cell's
window in which no kernel, copy or set ran on the device, in percent:
100 (1 - busy / stretch), from the profiler's trace."""


def read(run):
    t = run.trace
    if t is None or t.window_s <= 0 or t.busy_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
