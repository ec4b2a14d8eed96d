"""Wire seconds a verify batch: the benchmark's own span around
``serde.read_json`` of the batch's proofs."""


def read(r):
    if r.path != "verify":
        return None
    return r.spans.per_batch({"serde"}, r.batches)
