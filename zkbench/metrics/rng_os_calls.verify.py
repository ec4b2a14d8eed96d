"""Calls into the OS's CSPRNG a verify batch: the port's counter
``rng.os_calls`` (``RandomSource.random_bytes``), over every span of its
verify calls."""

from zkbench.harness import port_record


def read(r):
    if r.path != "verify":
        return None
    return port_record.counter(r, "rng.os_calls")
