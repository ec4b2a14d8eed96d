"""Per cent: the least time of the traced prove batches' device work at
their sizes (``zkbench/roofline/prove.json``, priced by
``zkbench/roofline/model.py``) over the summed device time of every
kernel in them, from the profiler's trace."""


def read(r):
    if r.path != "prove" or r.trace is None or not r.trace.kernel_s or r.least_s is None:
        return None
    return 100.0 * r.least_s / r.trace.kernel_s
