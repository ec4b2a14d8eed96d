"""Wire seconds a prove batch: the benchmark's own span around
``serde.write_json`` of the batch's proofs."""


def read(r):
    if r.path != "prove":
        return None
    return r.spans.per_batch({"serde"}, r.batches)
