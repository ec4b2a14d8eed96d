"""Randomness seam for the whole framework.

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
import time
from contextlib import contextmanager
from typing import Iterator

from . import profiling

# calls into the OS's CSPRNG, their bytes and seconds, while a tracer is installed
_OS = profiling.Tally("rng.os_calls", "rng.os_bytes", "rng.os_s")


class RandomSource:
    """OS-CSPRNG random source (default).  While a tracer is installed
    (``utils.profiling.tracing``) each call is counted: ``rng.os_calls``,
    ``rng.os_bytes`` and ``rng.os_s``, the seconds inside the OS source."""

    def random_bytes(self, n: int) -> bytes:
        from ..runtime import native

        if profiling.TRACER is None:
            return native.fill_random(n)
        t0 = time.perf_counter()
        out = native.fill_random(n)
        v = _OS.values
        v[2] += time.perf_counter() - t0
        v[0] += 1
        v[1] += n
        return out


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
        if n > 512:
            return self._random_bytes_bulk(n)
        while len(self._buf) < n:
            block = hashlib.sha256(
                self._key + self._counter.to_bytes(8, "big")
            ).digest()
            self._counter += 1
            self._buf += block
        out, self._buf = self._buf[:n], self._buf[n:]
        return out

    def _random_bytes_bulk(self, n: int) -> bytes:
        """Same byte stream as the sequential path (block i =
        SHA-256(key || counter_i)), generated with one threaded
        ``sha256_rows`` batch instead of per-block hashlib calls plus
        quadratic buffer appends - the batched prover's tape fill draws
        ~64 KB per instance (see bignum.big.rnd_many)."""
        import numpy as np

        from ..runtime import native

        blocks = -(-(n - len(self._buf)) // 32)
        msgs = np.empty((blocks, 40), np.uint8)
        msgs[:, :32] = np.frombuffer(self._key, np.uint8)
        msgs[:, 32:] = (
            np.arange(self._counter, self._counter + blocks, dtype=np.uint64)
            .astype(">u8")
            .view(np.uint8)
            .reshape(blocks, 8)
        )
        self._counter += blocks
        stream = self._buf + native.sha256_rows(msgs).tobytes()
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
