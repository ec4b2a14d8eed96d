"""Seconds a verify batch in which the interpreter's cyclic garbage
collector ran (every generation), from ``gc.callbacks`` over the traced
batches.  The batches make millions of small objects (points, scalars,
relations), so the collector's passes over them are a host layer of their
own."""


def read(r):
    if r.path != "verify" or not r.gc_s or not r.batches:
        return None
    return sum(r.gc_s.get(b, 0.0) for b in r.batches) / len(r.batches)
