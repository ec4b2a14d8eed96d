"""Curve algebraic-property tests (model: reference test/curves/ec.test.ts).

The port's copy of the reference package's tests/test_curves.py: the same
cases over ``zkecdsa_tpu_torch``'s host layer, on the port's own
deterministic tape (tests/conftest.py installs the JAX package's).
"""

import pytest
import torch

from zkecdsa_tpu_torch.bignum import big
from zkecdsa_tpu_torch.curves import ALL_GROUPS, Scalar
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


@pytest.mark.parametrize("g", ALL_GROUPS, ids=lambda g: g.name)
def test_order_times_generator_is_identity(g):
    G = g.generator()
    assert G.mul(g.new_scalar(g.order - 1)).add(G).is_identity()
    # mul by order directly: scalar reduces to 0 -> identity
    assert G.mul(g.new_scalar(g.order)).is_identity()


@pytest.mark.parametrize("g", ALL_GROUPS, ids=lambda g: g.name)
def test_random_mul_stays_on_curve(g):
    G = g.generator()
    for _ in range(4):
        P = G.mul(g.random_scalar())
        assert g.is_on_group(P)


@pytest.mark.parametrize("g", ALL_GROUPS, ids=lambda g: g.name)
def test_add_dbl_neg_consistency(g):
    G = g.generator()
    P = G.mul(g.new_scalar(0xABCDEF))
    assert P.add(P).eq(P.dbl())
    assert P.add(P.neg()).is_identity()
    assert P.add(g.identity()).eq(P)
    assert g.identity().add(P).eq(P)
    assert P.sub(P).is_identity()


@pytest.mark.parametrize("g", ALL_GROUPS, ids=lambda g: g.name)
def test_dblmul_matches_separate_muls(g):
    G = g.generator()
    Q = G.mul(g.new_scalar(98765))
    k1, k2 = g.random_scalar(), g.random_scalar()
    assert G.dblmul(k1, Q, k2).eq(G.mul(k1).add(Q.mul(k2)))


@pytest.mark.parametrize("g", ALL_GROUPS, ids=lambda g: g.name)
def test_mul_distributes(g):
    G = g.generator()
    a, b = g.random_scalar(), g.random_scalar()
    assert G.mul(a).add(G.mul(b)).eq(G.mul(a.add(b)))


@pytest.mark.parametrize("g", ALL_GROUPS, ids=lambda g: g.name)
def test_point_byte_round_trip(g):
    G = g.generator()
    P = G.mul(g.new_scalar(31337))
    assert g.deserialize_point(P.to_bytes()).eq(P)


def test_weierstrass_identity_bytes():
    g = ALL_GROUPS[0]
    assert g.identity().to_bytes() == b"\x00"  # weier.ts:75-76
    assert g.deserialize_point(b"\x00").is_identity()


@pytest.mark.parametrize("g", ALL_GROUPS, ids=lambda g: g.name)
def test_bad_point_bytes_rejected(g):
    with pytest.raises(ValueError):
        g.deserialize_point(b"\x04" + b"\x01" * (g.size_point_bytes() - 1))


@pytest.mark.parametrize("g", ALL_GROUPS, ids=lambda g: g.name)
def test_scalar_arithmetic(g):
    a = g.new_scalar(g.order - 1)
    b = g.new_scalar(2)
    assert a.add(b).k == 1
    assert b.sub(a).k == 3
    assert a.mul(b).k == g.order - 2
    assert a.neg().k == 1
    assert g.new_scalar(5).inv().mul(g.new_scalar(5)).is_one()


@pytest.mark.parametrize("g", ALL_GROUPS, ids=lambda g: g.name)
def test_scalar_deserialize_range_checked(g):
    data = big.to_bytes(g.order - 1, g.size_field_bytes())
    assert g.deserialize_scalar(data).k == g.order - 1
    with pytest.raises(ValueError):
        g.deserialize_scalar(big.to_bytes(g.order, g.size_field_bytes()))


@pytest.mark.parametrize("g", ALL_GROUPS, ids=lambda g: g.name)
def test_point_scalar_json_round_trip(g):
    P = g.generator().mul(g.new_scalar(424242))
    P2 = read_json(type(P), write_json(type(P), P))
    assert P2.eq(P)
    s = g.random_scalar()
    s2 = read_json(Scalar, write_json(Scalar, s))
    assert s2.eq(s)


def test_tom_field_is_33_bytes():
    from zkecdsa_tpu_torch.curves import tomEdwards256

    assert tomEdwards256.size_field_bytes() == 33  # edwards.ts:69 quirk
    assert tomEdwards256.size_point_bytes() == 67


def test_cross_group_ops_rejected():
    g1, g2 = ALL_GROUPS[0], ALL_GROUPS[1]
    with pytest.raises(ValueError):
        g1.generator().add(g2.generator())
    with pytest.raises(ValueError):
        g1.generator().mul(g2.new_scalar(3))
