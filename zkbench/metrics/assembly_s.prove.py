"""Host pack, unpack and assembly seconds a prove batch: the self time of
the port's stages ``assembly``, ``gk.assemble``, ``phase_a.pack``,
``phase_a.unpack``, ``phase_b.pack`` and ``phase_b.unpack``."""

STAGES = {"assembly", "gk.assemble", "phase_a.pack", "phase_a.unpack", "phase_b.pack", "phase_b.unpack"}


def read(r):
    if r.path != "prove":
        return None
    return r.spans.per_batch(STAGES, r.batches)
