"""Per cent of the traced verify batches' window in which no device
operation (kernel, copy or set) ran, from the profiler's trace."""


def read(r):
    if r.path != "verify" or r.trace is None or r.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - r.trace.busy_s / r.trace.window_s)
