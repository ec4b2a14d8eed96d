"""Point-addition proof tests (model: reference test/exp/pointAdd.test.ts:
P-256 points, Tom-256 commitments).

The port's copy of the reference package's tests/test_pointadd.py: the same
cases over ``zkecdsa_tpu_torch``'s host layer, on the port's own
deterministic tape (tests/conftest.py installs the JAX package's).
"""

import pytest
import torch

from zkecdsa_tpu_torch.commit import generate_pedersen_params
from zkecdsa_tpu_torch.curves import p256, tomEdwards256
from zkecdsa_tpu_torch.exp import (
    PointAddProof,
    prove_point_add,
    verify_point_add,
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


def _setup():
    params = generate_pedersen_params(tomEdwards256)
    G = p256.generator()
    P = G.mul(p256.random_scalar())
    Q = G.mul(p256.random_scalar())
    R = P.add(Q)
    coords = [pt.to_affine() for pt in (P, Q, R)]
    commits = []
    for x, y in coords:
        commits.append(params.commit(x))
        commits.append(params.commit(y))
    PX, PY, QX, QY, RX, RY = commits
    return params, P, Q, R, PX, PY, QX, QY, RX, RY


def test_point_add_round_trip():
    params, P, Q, R, PX, PY, QX, QY, RX, RY = _setup()
    pi = prove_point_add(params, P, Q, R, PX, PY, QX, QY, RX, RY)
    assert verify_point_add(params, PX.p, PY.p, QX.p, QY.p, RX.p, RY.p, pi)
    pi2 = read_json(PointAddProof, write_json(PointAddProof, pi))
    assert pi2.eq(pi)
    assert verify_point_add(params, PX.p, PY.p, QX.p, QY.p, RX.p, RY.p, pi2)


def test_point_add_rejects_wrong_sum():
    params, P, Q, R, PX, PY, QX, QY, RX, RY = _setup()
    with pytest.raises(ValueError):
        prove_point_add(params, P, Q, R.dbl(), PX, PY, QX, QY, RX, RY)


def test_point_add_rejects_tampered_commitment():
    params, P, Q, R, PX, PY, QX, QY, RX, RY = _setup()
    pi = prove_point_add(params, P, Q, R, PX, PY, QX, QY, RX, RY)
    assert not verify_point_add(
        params, PX.p.dbl(), PY.p, QX.p, QY.p, RX.p, RY.p, pi
    )


def test_point_add_rejects_infinity_inputs():
    params, P, Q, R, PX, PY, QX, QY, RX, RY = _setup()
    ident = p256.identity()
    with pytest.raises(ValueError):
        prove_point_add(params, ident, ident, ident, PX, PY, QX, QY, RX, RY)
