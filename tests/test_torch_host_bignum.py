"""Host bignum tests (model: reference test/bignum/big.test.ts).

The port's copy of the reference package's tests/test_bignum.py: the same
cases over ``zkecdsa_tpu_torch``'s host layer, on the port's own
deterministic tape (tests/conftest.py installs the JAX package's).
"""

import pytest
import torch

from zkecdsa_tpu_torch.bignum import big
from zkecdsa_tpu_torch.curves.instances import p256, war256
from zkecdsa_tpu_torch.utils import rng as port_rng

# One intra-op thread: the suite runs several worker processes on the same
# cores, and an oversubscribed OpenMP pool spins instead of working.
torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def port_deterministic_rng():
    """Every test runs on a reproducible random tape of the port's source."""
    with port_rng.deterministic(0xC0FFEE):
        yield


def test_inv_euclid_known_answers():
    # invEuclid(3, 5) = 2, invEuclid(7, 41) = 6 (big.test.ts:18-20)
    assert big.inv_euclid(3, 5) == 2
    assert big.inv_euclid(7, 41) == 6
    assert big.inv_euclid(0, 97) == 0  # reference quirk: inv(0) == 0


def test_inv_mod_random():
    p = p256.p
    for a in (2, 3, 12345, p - 1, 0xDEADBEEF):
        assert big.inv_mod(a, p) * a % p == 1


def test_is_prime_known_answers():
    # (big.test.ts:22-49)
    assert big.is_prime(23)
    assert not big.is_prime(221)
    assert big.is_prime(257)
    assert not big.is_prime(477)
    assert big.is_prime(war256.p)
    assert big.is_prime(p256.p)
    assert big.is_prime(p256.order)


def test_bytes_round_trip():
    for v in (0, 1, 255, 256, p256.p - 1):
        b = big.to_bytes(v, 32)
        assert len(b) == 32
        assert big.from_bytes(b) == v
    with pytest.raises(ValueError):
        big.to_bytes(256, 1)
    with pytest.raises(ValueError):
        big.to_bytes(-1, 4)


def test_bit_byte_len():
    assert big.bit_len(0) == 1  # reference counts '0' as one digit
    assert big.bit_len(1) == 1
    assert big.bit_len(255) == 8
    assert big.byte_len(255) == 1
    assert big.byte_len(256) == 2


def test_pos_mod_exp_mod():
    assert big.pos_mod(-3, 7) == 4
    assert big.exp_mod(2, 10, 1000) == 24
    with pytest.raises(ValueError):
        big.exp_mod(2, -1, 5)


def test_sqrt_and_square():
    p = p256.p  # p = 3 mod 4
    x = 0x1234567890ABCDEF
    sq = x * x % p
    assert big.is_square(sq, p)
    r = big.inv_sqrt_mod(sq, p)
    # r = 1/sqrt(sq) => r^2 * sq == 1
    assert r * r % p * sq % p == 1


def test_hash_nums_is_80_bit_and_deterministic():
    h1 = big.hash_nums([1, 2, 3])
    h2 = big.hash_nums([1, 2, 3])
    assert h1 == h2
    assert h1 < 1 << 80
    assert big.hash_nums([12, 3]) != big.hash_nums([1, 23])  # length-prefixed


def test_rnd_in_range():
    for _ in range(50):
        n = 1000
        v = big.rnd(n)
        assert 0 <= v < n
    v = big.rnd_range(-5, 5)
    assert -5 <= v <= 5


def test_hex_serde():
    assert big.int_to_hex(255) == "0xff"
    assert big.int_to_hex(-255) == "-0xff"
    assert big.int_to_hex(0) == "0x0"
    assert big.hex_to_int("0xff") == 255
    assert big.hex_to_int("-0xff") == -255
    with pytest.raises(ValueError):
        big.hex_to_int("")
