"""Host preparation seconds a verify batch: the self time of the port's
stage ``verify.host_prep`` (parsing, the exponent challenges' hashes, the
round sample)."""


def read(r):
    if r.path != "verify":
        return None
    return r.spans.per_batch({"verify.host_prep"}, r.batches)
