"""GK seconds a verify batch: the self time of the port's stage
``verify.gk_recombine`` (the length checks, each proof's GK challenge with
the hardened statement binding, the ring fold on the card)."""


def read(r):
    if r.path != "verify":
        return None
    return r.spans.per_batch({"verify.gk_recombine"}, r.batches)
