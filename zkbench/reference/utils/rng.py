"""Randomness seam of the plain reference: the port's DRBG stream
(SHA-256 counter mode), drawn with ``hashlib`` alone.

The reference library draws randomness from WebCrypto's CSPRNG
(``crypto.getRandomValues``, reference src/bignum/big.ts:171-185) via rejection
sampling.  We replace that platform primitive with a pluggable source so that

* production uses the OS CSPRNG (``secrets``/``os.urandom``), and
* tests can install a deterministic DRBG, which lets us check the batched
  prover bit-exactly against the scalar host prover (same random tape -> same
  proof bytes).

All protocol code MUST draw randomness through :func:`rnd` / :func:`rnd_range`
so the tape is reproducible.
"""

from __future__ import annotations

import hashlib
import os
from contextlib import contextmanager
from typing import Iterator


class RandomSource:
    """OS-CSPRNG random source (default)."""

    def random_bytes(self, n: int) -> bytes:
        return os.urandom(n)


class DeterministicSource(RandomSource):
    """SHA-256 counter-mode DRBG. NOT cryptographically hygienic for
    production (no reseed / backtracking resistance); used for reproducible
    tests and cross-checking the batched prover against the scalar prover."""

    def __init__(self, seed: bytes | int = 0) -> None:
        if isinstance(seed, int):
            seed = seed.to_bytes(32, "big")
        self._key = hashlib.sha256(b"zkecdsa-tpu-drbg" + seed).digest()
        self._counter = 0
        self._buf = b""

    def random_bytes(self, n: int) -> bytes:
        blocks = [self._buf]
        have = len(self._buf)
        while have < n:
            blocks.append(hashlib.sha256(self._key + self._counter.to_bytes(8, "big")).digest())
            self._counter += 1
            have += 32
        stream = b"".join(blocks)
        out, self._buf = stream[:n], stream[n:]
        return out

    # exact-replay snapshots (rnd_many's rejection fallback)
    def state(self) -> tuple:
        return (self._counter, self._buf)

    def restore(self, state: tuple) -> None:
        self._counter, self._buf = state


_source: RandomSource = RandomSource()


def get_source() -> RandomSource:
    return _source


def set_source(src: RandomSource) -> None:
    global _source
    _source = src


@contextmanager
def scoped(source: RandomSource) -> Iterator[RandomSource]:
    """Temporarily install an explicit source (used by the batched prover to
    replay per-instance tapes)."""
    global _source
    prev = _source
    _source = source
    try:
        yield source
    finally:
        _source = prev


@contextmanager
def deterministic(seed: bytes | int = 0) -> Iterator[DeterministicSource]:
    """Context manager installing a seeded DRBG for the duration."""
    global _source
    prev = _source
    src = DeterministicSource(seed)
    _source = src
    try:
        yield src
    finally:
        _source = prev


def random_bytes(n: int) -> bytes:
    return _source.random_bytes(n)
