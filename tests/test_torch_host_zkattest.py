"""End-to-end ZKAttest tests (model: reference test/zkpAttestList.test.ts:
keygen + ECDSA sign -> ring of 6 -> prove -> verify -> serde round-trips),
plus negatives the reference lacks.

The port's copy of the reference package's tests/test_zkattest.py: the same
cases over ``zkecdsa_tpu_torch``'s host layer, on the port's own
deterministic tape (tests/conftest.py installs the JAX package's).
"""

import hashlib

import pytest
import torch

from zkecdsa_tpu_torch import (
    SignatureProofList,
    SystemParametersList,
    generate_params_list,
    key_to_int,
    prove_signature_list,
    read_json,
    verify_signature_list,
    write_json,
)
from zkecdsa_tpu_torch import ecdsa
from zkecdsa_tpu_torch.utils import rng as port_rng

# One intra-op thread: the suite runs several worker processes on the same
# cores, and an oversubscribed OpenMP pool spins instead of working.
torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def port_deterministic_rng():
    """Every test runs on a reproducible random tape of the port's source."""
    with port_rng.deterministic(0xC0FFEE):
        yield


@pytest.fixture(scope="module")
def e2e():
    """One prove/verify setup shared by the module (proving is the
    expensive part of the host path)."""
    from zkecdsa_tpu_torch.utils import rng

    with rng.deterministic(7):
        kp = ecdsa.generate_keypair()
        msg = b"kilroy was here"
        sig = ecdsa.sign(kp, msg)
        msg_hash = hashlib.sha256(msg).digest()
        pub_raw = ecdsa.export_public_raw(kp)
        ring = [key_to_int(pub_raw), 4, 5, 6, 7, 8]
        params = generate_params_list()
        proof = prove_signature_list(params, msg_hash, sig, pub_raw, 0, ring)
    return params, msg_hash, ring, proof


def test_ecdsa_self_consistent():
    kp = ecdsa.generate_keypair()
    sig = ecdsa.sign(kp, b"hello")
    assert ecdsa.verify(kp.public, b"hello", sig)
    assert not ecdsa.verify(kp.public, b"tampered", sig)


def test_prove_verify(e2e):
    params, msg_hash, ring, proof = e2e
    assert verify_signature_list(params, msg_hash, ring, proof)


def test_proof_serde_round_trip(e2e):
    params, msg_hash, ring, proof = e2e
    text = write_json(SignatureProofList, proof)
    proof2 = read_json(SignatureProofList, text)
    assert proof2.eq(proof)
    assert verify_signature_list(params, msg_hash, ring, proof2)
    # stable re-serialization
    assert write_json(SignatureProofList, proof2) == text


def test_params_serde_round_trip(e2e):
    params, *_ = e2e
    text = write_json(SystemParametersList, params)
    params2 = read_json(SystemParametersList, text)
    assert params2.eq(params)


def test_verify_rejects_wrong_message(e2e):
    params, msg_hash, ring, proof = e2e
    other_hash = hashlib.sha256(b"not the message").digest()
    assert not verify_signature_list(params, other_hash, ring, proof)


def test_verify_rejects_wrong_ring(e2e):
    params, msg_hash, ring, proof = e2e
    other_ring = [9, 10, 11, 12, 13, 14]
    assert not verify_signature_list(params, other_ring[:6], other_ring, proof)
    assert not verify_signature_list(params, msg_hash, other_ring, proof)


def test_verify_rejects_tampered_commitment(e2e):
    params, msg_hash, ring, proof = e2e
    tampered = read_json(
        SignatureProofList, write_json(SignatureProofList, proof)
    )
    tampered.keyXcom = tampered.keyXcom.dbl()
    assert not verify_signature_list(params, msg_hash, ring, tampered)


def test_proof_has_expected_shape(e2e):
    params, msg_hash, ring, proof = e2e
    assert len(proof.expProof) == 80  # prover rounds = SecLevel
    assert len(proof.membershipProof.cl) == 3  # ring of 6 pads to 8 = 2^3
