"""Exp proof tests (model: reference test/exp/exp.test.ts: secLevel 80,
prove AND verify at 80).

The port's copy of the reference package's tests/test_exp.py: the same
cases over ``zkecdsa_tpu_torch``'s host layer, on the port's own
deterministic tape (tests/conftest.py installs the JAX package's).
"""

import pytest
import torch

from zkecdsa_tpu_torch.bignum import big
from zkecdsa_tpu_torch.commit import PedersenParams, generate_pedersen_params
from zkecdsa_tpu_torch.curves import p256, tomEdwards256
from zkecdsa_tpu_torch.exp import prove_exp, verify_exp
from zkecdsa_tpu_torch.exp.exp import generate_indices, padded_bits
from zkecdsa_tpu_torch.serde import read_json, write_json
from zkecdsa_tpu_torch.zkp_attest_list import SignatureProofList  # noqa: F401
from zkecdsa_tpu_torch.utils import rng as port_rng

# One intra-op thread: the suite runs several worker processes on the same
# cores, and an oversubscribed OpenMP pool spins instead of working.
torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def port_deterministic_rng():
    """Every test runs on a reproducible random tape of the port's source."""
    with port_rng.deterministic(0xC0FFEE):
        yield


def _setup(sec=80, with_q=False):
    params_nist = generate_pedersen_params(p256)
    params_proof = generate_pedersen_params(tomEdwards256)
    s = big.rnd(p256.order)
    # statement: s*R = P (+Q), Cs = s*R + r*S with paramsNIST.g = R
    Q = p256.generator().mul(p256.random_scalar()) if with_q else None
    P = params_nist.g.mul(p256.new_scalar(s))
    if Q is not None:
        P = P.sub(Q)
    Cs = params_nist.commit(s)
    px, py = P.to_affine()
    Px = params_proof.commit(px)
    Py = params_proof.commit(py)
    return params_nist, params_proof, s, Cs, P, Px, Py, Q


def test_exp_round_trip_sec80():
    params_nist, params_proof, s, Cs, P, Px, Py, Q = _setup(80)
    pi = prove_exp(params_nist, params_proof, s, Cs, P, Px, Py, 80, Q)
    assert len(pi) == 80
    assert verify_exp(params_nist, params_proof, Cs.p, Px.p, Py.p, pi, 80, Q)


def test_exp_with_q_and_spot_check_20():
    params_nist, params_proof, s, Cs, P, Px, Py, Q = _setup(80, with_q=True)
    pi = prove_exp(params_nist, params_proof, s, Cs, P, Px, Py, 80, Q)
    # top-level verifier behavior: spot-check only 20 of the 80 rounds
    assert verify_exp(params_nist, params_proof, Cs.p, Px.p, Py.p, pi, 20, Q)


def test_exp_serde_round_trip():
    params_nist, params_proof, s, Cs, P, Px, Py, Q = _setup(16)
    pi = prove_exp(params_nist, params_proof, s, Cs, P, Px, Py, 16, Q)
    from zkecdsa_tpu_torch.exp import ExpProof

    for p in pi[:4]:
        p2 = read_json(ExpProof, write_json(ExpProof, p))
        assert p2.eq(p)
    assert verify_exp(params_nist, params_proof, Cs.p, Px.p, Py.p, pi, 16, Q)


def test_exp_rejects_tampered_statement():
    params_nist, params_proof, s, Cs, P, Px, Py, Q = _setup(16)
    pi = prove_exp(params_nist, params_proof, s, Cs, P, Px, Py, 16, Q)
    # verifying against a different commitment to the secret must fail
    assert not verify_exp(
        params_nist, params_proof, Cs.p.dbl(), Px.p, Py.p, pi, 16, Q
    )


def test_exp_requires_enough_rounds():
    params_nist, params_proof, s, Cs, P, Px, Py, Q = _setup(8)
    pi = prove_exp(params_nist, params_proof, s, Cs, P, Px, Py, 8, Q)
    import pytest

    with pytest.raises(ValueError):
        verify_exp(params_nist, params_proof, Cs.p, Px.p, Py.p, pi, 9, Q)


def test_padded_bits_lsb_first():
    assert padded_bits(0b1011, 6) == [True, True, False, True, False, False]


def test_generate_indices_is_permutation():
    idx = generate_indices(20, 80)
    assert sorted(idx) == list(range(80))  # full permutation (exp.ts:107 no-op)
