"""Per cent of ``bignum.rnd``'s attempts a verify batch that were
rejected: 100 (draws - calls) / draws from the port's counters
``rnd.draws`` (attempts) and ``rnd.calls``, over every span of its verify
calls; most are the round sample's one-byte draws of small ranges."""

from zkbench.harness import port_record


def read(r):
    if r.path != "verify":
        return None
    calls, draws = port_record.counter(r, "rnd.calls"), port_record.counter(r, "rnd.draws")
    if calls is None or not draws:
        return None
    return 100.0 * (draws - calls) / draws
