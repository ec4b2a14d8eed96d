"""C++ native runtime vs hashlib/secrets.

The port's copy of the reference package's tests/test_runtime.py: the same
cases over ``zkecdsa_tpu_torch``'s host layer, on the port's own
deterministic tape (tests/conftest.py installs the JAX package's).
"""

import hashlib

import pytest
import torch

from zkecdsa_tpu_torch.runtime import native
from zkecdsa_tpu_torch.utils import rng as port_rng

# One intra-op thread: the suite runs several worker processes on the same
# cores, and an oversubscribed OpenMP pool spins instead of working.
torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def port_deterministic_rng():
    """Every test runs on a reproducible random tape of the port's source."""
    with port_rng.deterministic(0xC0FFEE):
        yield


def test_sha256_matches_hashlib():
    for msg in (b"", b"abc", b"x" * 55, b"y" * 56, b"z" * 64, b"w" * 1000):
        assert native.sha256(msg) == hashlib.sha256(msg).digest()


def test_sha256_batch_matches():
    msgs = [bytes([i]) * (i * 7 % 200) for i in range(50)]
    assert native.sha256_batch(msgs) == [
        hashlib.sha256(m).digest() for m in msgs
    ]


def test_fill_random():
    a = native.fill_random(32)
    b = native.fill_random(32)
    assert len(a) == 32 and a != b
