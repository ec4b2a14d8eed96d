"""Host pack, unpack and assembly seconds a verify batch: the self time of
the port's stages ``verify.unpack``, ``verify.assemble``,
``msm.combine_host`` and ``msm.pack_host``."""

STAGES = {"verify.unpack", "verify.assemble", "msm.combine_host", "msm.pack_host"}


def read(r):
    if r.path != "verify":
        return None
    return r.spans.per_batch(STAGES, r.batches)
