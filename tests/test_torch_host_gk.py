"""GK membership proof tests (model: reference test/proofGK/gk.test.ts:
ring [3,5,7,11,13] at index 3 - non-power-of-two exercises padding), plus
interpolation known answers and negatives.

The port's copy of the reference package's tests/test_gk.py: the same
cases over ``zkecdsa_tpu_torch``'s host layer, on the port's own
deterministic tape (tests/conftest.py installs the JAX package's).
"""

import pytest
import torch

from zkecdsa_tpu_torch.commit import generate_pedersen_params
from zkecdsa_tpu_torch.curves import tomEdwards256
from zkecdsa_tpu_torch.proofGK import (
    GKProof,
    eval_poly,
    interpolate,
    prove_membership,
    verify_membership,
)
from zkecdsa_tpu_torch.serde import read_json, write_json
from zkecdsa_tpu_torch.utils import rng as port_rng

# One intra-op thread: the suite runs several worker processes on the same
# cores, and an oversubscribed OpenMP pool spins instead of working.
torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def port_deterministic_rng():
    """Every test runs on a reproducible random tape of the port's source."""
    with port_rng.deterministic(0xC0FFEE):
        yield


def test_interpolate_identity_poly():
    # interpolate([1,2,3],[1,2,3]) mod 401 == x (interpolate.test.ts:19-26)
    assert interpolate([1, 2, 3], [1, 2, 3], 401) == [0, 1, 0]


def test_interpolate_random_poly():
    m = tomEdwards256.order
    coeffs = [12345, 67890, 13579, 24680]
    xs = [0, 1, 2, 3]
    ys = [eval_poly(coeffs, x, m) for x in xs]
    assert interpolate(xs, ys, m) == [c % m for c in coeffs]


def test_interpolate_raises_on_inconsistent_args():
    with pytest.raises(ValueError):
        interpolate([1, 2], [1], 401)


def _gk_setup(ring, index):
    params = generate_pedersen_params(tomEdwards256)
    com = params.commit(ring[index])
    return params, com


def test_gk_round_trip_padded_ring():
    ring = [3, 5, 7, 11, 13]  # pads to 8 by repeating element 0
    params, com = _gk_setup(ring, 3)
    pi = prove_membership(params, com, 3, ring)
    assert verify_membership(params, com.p, ring, pi)
    pi2 = read_json(GKProof, write_json(GKProof, pi))
    assert pi2.eq(pi)
    assert verify_membership(params, com.p, ring, pi2)


def test_gk_power_of_two_ring():
    ring = [17, 18, 19, 20]
    params, com = _gk_setup(ring, 0)
    pi = prove_membership(params, com, 0, ring)
    assert verify_membership(params, com.p, ring, pi)


def test_gk_rejects_wrong_index_commitment():
    ring = [3, 5, 7, 11, 13]
    params, com = _gk_setup(ring, 3)
    wrong_com = params.commit(999)  # commits a value not at any ring slot
    pi = prove_membership(params, wrong_com, 3, ring)
    assert not verify_membership(params, wrong_com.p, ring, pi)


def test_gk_rejects_wrong_ring():
    ring = [3, 5, 7, 11, 13]
    params, com = _gk_setup(ring, 3)
    pi = prove_membership(params, com, 3, ring)
    other = [4, 6, 8, 12, 14]
    assert not verify_membership(params, com.p, other, pi)


def test_gk_rejects_truncated_proof():
    ring = [3, 5, 7, 11, 13]
    params, com = _gk_setup(ring, 3)
    pi = prove_membership(params, com, 3, ring)
    pi.cl = pi.cl[:-1]
    assert not verify_membership(params, com.p, ring, pi)


def test_gk_larger_ring():
    ring = list(range(100, 132))  # 32 entries, n = 5
    params, com = _gk_setup(ring, 17)
    pi = prove_membership(params, com, 17, ring)
    assert verify_membership(params, com.p, ring, pi)
    assert len(pi.cl) == 5
