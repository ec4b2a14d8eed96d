"""Pedersen / equality / mult proof tests (model: reference
test/commit/*.test.ts, on tomEdwards256), plus negative tests the reference
lacks.

The port's copy of the reference package's tests/test_commit.py: the same
cases over ``zkecdsa_tpu_torch``'s host layer, on the port's own
deterministic tape (tests/conftest.py installs the JAX package's).
"""

import pytest
import torch

from zkecdsa_tpu_torch.bignum import big
from zkecdsa_tpu_torch.commit import (
    EqualityProof,
    MultProof,
    generate_pedersen_params,
    prove_equality,
    prove_mult,
    verify_equality,
    verify_mult,
)
from zkecdsa_tpu_torch.curves import tomEdwards256
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


def test_pedersen_commit_homomorphic():
    params = generate_pedersen_params(tomEdwards256)
    c1 = params.commit(5)
    c2 = params.commit(7)
    c12 = c1.add(c2)
    # c12 must be a commitment to 12 under blinding r1+r2
    expected = params.h.dblmul(c12.r, params.g, tomEdwards256.new_scalar(12))
    assert c12.p.eq(expected)
    c3 = c1.mul(3)
    expected = params.h.dblmul(c3.r, params.g, tomEdwards256.new_scalar(15))
    assert c3.p.eq(expected)


def test_equality_round_trip():
    params = generate_pedersen_params(tomEdwards256)
    x = big.rnd(tomEdwards256.order)
    C1 = params.commit(x)
    C2 = params.commit(x)
    pi = prove_equality(params, x, C1, C2)
    assert verify_equality(params, C1.p, C2.p, pi)
    pi2 = read_json(EqualityProof, write_json(EqualityProof, pi))
    assert pi2.eq(pi)
    assert verify_equality(params, C1.p, C2.p, pi2)


def test_equality_rejects_unequal_values():
    params = generate_pedersen_params(tomEdwards256)
    x = 1234
    C1 = params.commit(x)
    C2 = params.commit(x + 1)
    pi = prove_equality(params, x, C1, C2)
    assert not verify_equality(params, C1.p, C2.p, pi)


def test_equality_rejects_tampered_proof():
    params = generate_pedersen_params(tomEdwards256)
    x = 999
    C1, C2 = params.commit(x), params.commit(x)
    pi = prove_equality(params, x, C1, C2)
    pi.t_x = pi.t_x.add(tomEdwards256.new_scalar(1))
    assert not verify_equality(params, C1.p, C2.p, pi)


def test_mult_round_trip():
    g = tomEdwards256
    params = generate_pedersen_params(g)
    x = big.rnd(g.order)
    y = big.rnd(g.order)
    z = x * y % g.order
    Cx, Cy, Cz = params.commit(x), params.commit(y), params.commit(z)
    pi = prove_mult(params, x, y, z, Cx, Cy, Cz)
    assert verify_mult(params, Cx.p, Cy.p, Cz.p, pi)
    pi2 = read_json(MultProof, write_json(MultProof, pi))
    assert pi2.eq(pi)
    assert verify_mult(params, Cx.p, Cy.p, Cz.p, pi2)


def test_mult_rejects_wrong_product():
    g = tomEdwards256
    params = generate_pedersen_params(g)
    x, y = 3, 5
    Cx, Cy, Cz = params.commit(x), params.commit(y), params.commit(16)
    pi = prove_mult(params, x, y, 16, Cx, Cy, Cz)
    assert not verify_mult(params, Cx.p, Cy.p, Cz.p, pi)


def test_mult_rejects_tampered_point():
    g = tomEdwards256
    params = generate_pedersen_params(g)
    x, y = 11, 13
    z = x * y
    Cx, Cy, Cz = params.commit(x), params.commit(y), params.commit(z)
    pi = prove_mult(params, x, y, z, Cx, Cy, Cz)
    pi.C_4 = pi.C_4.dbl()
    assert not verify_mult(params, Cx.p, Cy.p, Cz.p, pi)
