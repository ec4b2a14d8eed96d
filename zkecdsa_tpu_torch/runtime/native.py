"""Hashing and OS randomness for the host layer, on ``hashlib`` and
``secrets``.

``DeterministicSource`` (utils/rng.py) needs SHA-256 streams byte-identical
to the reference package's, and hashlib gives them.  Batch entry points
keep the reference package's signatures so callers read the same.
"""

from __future__ import annotations

import hashlib
import secrets

import numpy as np

__all__ = ["sha256_batch", "sha256_rows", "fill_random"]


def sha256_batch(messages: list[bytes]) -> list[bytes]:
    """SHA-256 of each message."""
    return [hashlib.sha256(m).digest() for m in messages]


def sha256_rows(arr) -> np.ndarray:
    """Hash every row of a uint8 matrix [M, K]: returns [M, 32] uint8."""
    a = np.ascontiguousarray(arr, dtype=np.uint8)
    M, K = a.shape
    buf = a.tobytes()
    out = np.empty((M, 32), np.uint8)
    for i in range(M):
        out[i] = np.frombuffer(
            hashlib.sha256(buf[i * K : (i + 1) * K]).digest(), np.uint8
        )
    return out


def fill_random(n: int) -> bytes:
    """``n`` bytes from the OS CSPRNG."""
    return secrets.token_bytes(n)
