"""Frozen golden wire vectors (VERDICT r4 missing #1).

The wire-format contract (reference src/serde.ts:21-36 +
test/zkpAttestList.test.ts:28-54: JSON with hex bigints, affine points,
group-name singletons, declaration-order keys) was previously only checked
self-referentially - batched-vs-host equality and round-trips would both
pass if a regression changed every prover identically.  These vectors
anchor the format: a ``SystemParametersList`` and a ``SignatureProofList``
generated once on deterministic tapes (tests/vectors/golden_inputs.json
records every input) and committed frozen.  Any change to serde, the
Fiat-Shamir transcripts, the DRBG, or the proof math that alters a single
wire byte fails here.

Regenerating the vectors is a deliberate act (see git history of
tests/vectors/) - never regenerate to make a red test green without
understanding exactly which observable behavior changed.

The port's copy of the reference package's tests/test_golden_vectors.py: the same
cases over ``zkecdsa_tpu_torch``'s host layer, on the port's own
deterministic tape (tests/conftest.py installs the JAX package's).
"""

import hashlib
import json
import os

import pytest
import torch

from zkecdsa_tpu_torch.serde import read_json, write_json
from zkecdsa_tpu_torch.utils import rng
from zkecdsa_tpu_torch.zkp_attest_list import (
    SignatureProofList,
    SystemParametersList,
    prove_signature_list,
    verify_signature_list,
)

# One intra-op thread: the suite runs several worker processes on the same
# cores, and an oversubscribed OpenMP pool spins instead of working.
torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def port_deterministic_rng():
    """Every test runs on a reproducible random tape of the port's source."""
    with rng.deterministic(0xC0FFEE):
        yield

VEC = os.path.join(os.path.dirname(__file__), "vectors")


def _load(name):
    with open(os.path.join(VEC, name)) as fh:
        return fh.read()


def test_golden_params_reproduce_byte_exact():
    inputs = json.loads(_load("golden_inputs.json"))
    from zkecdsa_tpu_torch import ecdsa
    from zkecdsa_tpu_torch.zkp_attest_list import generate_params_list

    with rng.deterministic(inputs["params_seed"]):
        params = generate_params_list()
        kp = ecdsa.generate_keypair()
        pub = ecdsa.export_public_raw(kp)
    assert pub.hex() == inputs["pub_hex"]
    assert write_json(SystemParametersList, params) == _load(
        "golden_params.json"
    )


def test_golden_proof_reproduces_byte_exact():
    inputs = json.loads(_load("golden_inputs.json"))
    params = read_json(SystemParametersList, _load("golden_params.json"))
    msg_hash = bytes.fromhex(inputs["msg_hash_hex"])
    ring = [int(v, 16) for v in inputs["ring"]]
    with rng.deterministic(inputs["tape_seed"]):
        proof = prove_signature_list(
            params,
            msg_hash,
            bytes.fromhex(inputs["sig_hex"]),
            bytes.fromhex(inputs["pub_hex"]),
            inputs["which"],
            ring,
        )
    assert write_json(SignatureProofList, proof) == _load("golden_proof.json")


def test_golden_proof_verifies_and_reserializes_stably():
    inputs = json.loads(_load("golden_inputs.json"))
    params = read_json(SystemParametersList, _load("golden_params.json"))
    blob = _load("golden_proof.json")
    proof = read_json(SignatureProofList, blob)
    # parse -> re-serialize is the identity on the frozen bytes
    assert write_json(SignatureProofList, proof) == blob
    ring = [int(v, 16) for v in inputs["ring"]]
    assert verify_signature_list(
        params, bytes.fromhex(inputs["msg_hash_hex"]), ring, proof
    )
    # sanity: the recorded message hashes to the recorded digest
    assert hashlib.sha256(inputs["message"].encode()).hexdigest() == (
        inputs["msg_hash_hex"]
    )
