"""The port's batched prover (``zkecdsa_tpu_torch.protocol.batch``) against
the JAX package's batched prover and host prover, end to end on the CPU.

Parameters cross to the port on the wire (``carry.params_from_jax``); both
packages draw each instance's randomness from the same
``DeterministicSource`` tape, so the proofs must be the same bytes.  On the
CPU the port's kernel wrappers take their plain PyTorch versions.
"""

import hashlib
import json
from pathlib import Path

import pytest
import torch

from zkecdsa_tpu import ecdsa as jecdsa
from zkecdsa_tpu.protocol.batch import BatchProver as JBatchProver
from zkecdsa_tpu.serde import write_json as jwrite_json
from zkecdsa_tpu.utils import rng as jrng
from zkecdsa_tpu.zkp_attest_list import SignatureProofList as JProof
from zkecdsa_tpu.zkp_attest_list import SystemParametersList as JParams
from zkecdsa_tpu.zkp_attest_list import generate_params_list as jgenerate_params
from zkecdsa_tpu.zkp_attest_list import prove_signature_list as jprove
from zkecdsa_tpu_torch import carry
from zkecdsa_tpu_torch.protocol import batch as tbatch
from zkecdsa_tpu_torch.protocol.batch_verify import BatchVerifier
from zkecdsa_tpu_torch.serde import read_json, write_json
from zkecdsa_tpu_torch.utils import rng as trng
from zkecdsa_tpu_torch.utils.profiling import StageTimer
from zkecdsa_tpu_torch.zkp_attest_list import SignatureProofList, SystemParametersList

# One intra-op thread: the suite runs several worker processes on the same
# cores, and an oversubscribed OpenMP pool spins instead of working.
torch.set_num_threads(1)

VEC = Path(__file__).resolve().parent / "vectors"


def _tapes(seeds):
    return [trng.DeterministicSource(s) for s in seeds]


def _wire(proofs) -> list[str]:
    return [write_json(SignatureProofList, p) for p in proofs]


@pytest.fixture(scope="module")
def gate():
    """The inputs of tests/test_pipeline_gate.py (one proof, ring of 4),
    proved by the JAX BatchProver on tape 4242 and by the port's."""
    with jrng.deterministic(77):
        params = jgenerate_params()
        kp = jecdsa.generate_keypair()
        msg = b"gate"
        sig = jecdsa.sign(kp, msg)
        pub = jecdsa.export_public_raw(kp)
        mh = hashlib.sha256(msg).digest()
        ring = [jecdsa.key_to_int(pub), 11, 13, 17]
    ref = JBatchProver(params).prove([mh], [sig], [pub], [0], ring, [jrng.DeterministicSource(4242)])
    tparams = carry.params_from_jax(jwrite_json(JParams, params))
    timer = StageTimer("cpu")
    got = tbatch.BatchProver(tparams, device="cpu").prove(
        [mh], [sig], [pub], [0], ring, _tapes([4242]), timer=timer
    )
    return tparams, mh, ring, jwrite_json(JProof, ref[0]), got, timer


def test_batch_prover_matches_jax_batch_prover(gate):
    _, _, _, ref_json, got, timer = gate
    assert _wire(got) == [ref_json]
    assert {"phase_a.device", "phase_b.device", "gk.dvalues", "gk.commits", "assembly"} <= set(
        timer.stages
    )


def test_port_verifier_accepts_port_proofs(gate):
    tparams, mh, ring, _, got, _ = gate
    bad = hashlib.sha256(b"tampered").digest()
    bv = BatchVerifier(tparams, device="cpu")
    with trng.deterministic(6):
        assert bv.verify([mh], ring, got) == [True]
        assert bv.verify([bad], ring, got) == [False]


@pytest.fixture(scope="module")
def pair():
    """Two signers in a ring of 5 (padded to 8), as tests/
    test_batch_prove.py sets them up, with the JAX host prover's proofs."""
    with jrng.deterministic(123):
        params = jgenerate_params()
        msgs, sigs, pubs, ring = [], [], [], []
        for i in range(2):
            kp = jecdsa.generate_keypair()
            msg = f"message {i}".encode()
            sigs.append(jecdsa.sign(kp, msg))
            pubs.append(jecdsa.export_public_raw(kp))
            msgs.append(hashlib.sha256(msg).digest())
            ring.append(jecdsa.key_to_int(pubs[-1]))
        ring += [101, 103, 107]
    host = []
    for i in range(2):
        with jrng.scoped(jrng.DeterministicSource(1000 + i)):
            host.append(jwrite_json(JProof, jprove(params, msgs[i], sigs[i], pubs[i], i, ring)))
    tparams = carry.params_from_jax(jwrite_json(JParams, params))
    return tparams, msgs, sigs, pubs, ring, host


def test_batch_prover_matches_jax_host_prover(pair):
    tparams, msgs, sigs, pubs, ring, host = pair
    got = tbatch.batched_prove_signature_list(
        tparams, msgs, sigs, pubs, [0, 1], ring, _tapes([1000, 1001]), device="cpu"
    )
    assert _wire(got) == host


def test_chunked_prove_is_byte_identical(pair, monkeypatch):
    tparams, msgs, sigs, pubs, ring, host = pair
    monkeypatch.setattr(tbatch.BatchProver, "MAX_CHUNK", 1)
    got = tbatch.BatchProver(tparams, device="cpu").prove(
        msgs, sigs, pubs, [0, 1], ring, _tapes([1000, 1001])
    )
    assert _wire(got) == host


def test_batch_prover_reproduces_golden_proof():
    inputs = json.loads((VEC / "golden_inputs.json").read_text())
    params = read_json(SystemParametersList, (VEC / "golden_params.json").read_text())
    got = tbatch.BatchProver(params, device="cpu").prove(
        [bytes.fromhex(inputs["msg_hash_hex"])],
        [bytes.fromhex(inputs["sig_hex"])],
        [bytes.fromhex(inputs["pub_hex"])],
        [inputs["which"]],
        [int(v, 16) for v in inputs["ring"]],
        _tapes([inputs["tape_seed"]]),
    )
    assert _wire(got) == [(VEC / "golden_proof.json").read_text()]
