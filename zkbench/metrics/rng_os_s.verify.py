"""Seconds a verify batch inside the OS's CSPRNG: the port's counter
``rng.os_s`` (``RandomSource.random_bytes`` around ``native.fill_random``),
over every span of its verify calls: the round sample's one-byte draws,
the combined check's and the relations' 32-byte weights."""

from zkbench.harness import port_record


def read(r):
    if r.path != "verify":
        return None
    return port_record.counter(r, "rng.os_s")
