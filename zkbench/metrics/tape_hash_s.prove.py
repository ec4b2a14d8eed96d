"""Host tape and hashing seconds a prove batch: the self time of the
port's stages ``tape.phase_a``, ``tape.phase_b``, ``gk.tape``,
``challenges.hash`` and ``subproof.hash``."""

STAGES = {"tape.phase_a", "tape.phase_b", "gk.tape", "challenges.hash", "subproof.hash"}


def read(r):
    if r.path != "prove":
        return None
    return r.spans.per_batch(STAGES, r.batches)
