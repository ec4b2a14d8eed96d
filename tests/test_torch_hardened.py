"""The hardened security modes on the port, held against the JAX package:
the counterparts of tests/test_hardened.py (``hardened_pedersen``: h by
hash-to-curve; ``hardened_gk``: the GK challenge bound to the statement),
then the whole batched pipeline with both flags on.

The two packages keep separate configs; the ``hardened`` fixture sets both
flags in both and restores both afterwards.  Parameters, commitments and
proofs cross between the packages on the wire (serde JSON), and the same
tapes give the same bytes.  On the CPU the port's kernel wrappers take
their plain versions.
"""

import dataclasses
import hashlib

import numpy as np
import pytest
import torch

from zkecdsa_tpu import ecdsa as jecdsa
from zkecdsa_tpu.commit.pedersen import Commitment as JCommitment
from zkecdsa_tpu.commit.pedersen import PedersenParams as JPedersen
from zkecdsa_tpu.commit.pedersen import generate_pedersen_params as jgenerate_pedersen
from zkecdsa_tpu.curves.group import Point as JPoint
from zkecdsa_tpu.curves.group import Scalar as JScalar
from zkecdsa_tpu.curves.instances import tomEdwards256 as jtom
from zkecdsa_tpu.proofGK.gk import GKProof as JGKProof
from zkecdsa_tpu.proofGK.gk import prove_membership as jprove_membership
from zkecdsa_tpu.protocol.batch import BatchProver as JBatchProver
from zkecdsa_tpu.protocol.batch import device_params_for as jdevice_params_for
from zkecdsa_tpu.serde import read_json as jread_json
from zkecdsa_tpu.serde import write_json as jwrite_json
from zkecdsa_tpu.utils import config as jconfig
from zkecdsa_tpu.utils import rng as jrng
from zkecdsa_tpu.zkp_attest_list import SignatureProofList as JProof
from zkecdsa_tpu.zkp_attest_list import SystemParametersList as JParams
from zkecdsa_tpu.zkp_attest_list import generate_params_list as jgenerate_params
from zkecdsa_tpu.zkp_attest_list import verify_signature_list as jverify_host
from zkecdsa_tpu_torch import carry
from zkecdsa_tpu_torch.commit.pedersen import Commitment, PedersenParams, generate_pedersen_params, hash_to_point
from zkecdsa_tpu_torch.curves.group import Point, Scalar
from zkecdsa_tpu_torch.curves.instances import p256, tomEdwards256
from zkecdsa_tpu_torch.ops.field import P256_P
from zkecdsa_tpu_torch.proofGK.gk import GKProof, prove_membership, verify_membership
from zkecdsa_tpu_torch.protocol.batch import BatchProver, device_params_for
from zkecdsa_tpu_torch.protocol.batch_gk import batch_prove_membership, batch_verify_membership
from zkecdsa_tpu_torch.protocol.batch_verify import BatchVerifier
from zkecdsa_tpu_torch.serde import read_json, write_json
from zkecdsa_tpu_torch.utils import config as tconfig
from zkecdsa_tpu_torch.utils import rng as trng
from zkecdsa_tpu_torch.zkp_attest_list import SignatureProofList, SystemParametersList, prove_signature_list

# One intra-op thread: the suite runs several worker processes on the same
# cores, and an oversubscribed OpenMP pool spins instead of working.
torch.set_num_threads(1)

RING = [3, 5, 7, 11, 13]  # tests/test_hardened.py's ring (pads to 8)


@pytest.fixture(scope="module")
def hardened():
    """Both flags on in both packages for the module; both configs
    restored afterwards."""
    prev = jconfig.get_config(), tconfig.get_config()
    jconfig.set_config(dataclasses.replace(prev[0], hardened_pedersen=1, hardened_gk=1))
    tconfig.set_config(dataclasses.replace(prev[1], hardened_pedersen=1, hardened_gk=1))
    try:
        yield
    finally:
        jconfig.set_config(prev[0])
        tconfig.set_config(prev[1])


def _gk_unbound():
    """The port's and the reference's configs with ``hardened_gk`` off
    (restore with :func:`_gk_bound`)."""
    for cfg in (jconfig, tconfig):
        cfg.set_config(dataclasses.replace(cfg.get_config(), hardened_gk=0))


def _gk_bound():
    for cfg in (jconfig, tconfig):
        cfg.set_config(dataclasses.replace(cfg.get_config(), hardened_gk=1))


def _jcommitment(com: Commitment) -> JCommitment:
    """A port commitment as the reference's, across the wire."""
    return JCommitment(jread_json(JPoint, write_json(Point, com.p)), jread_json(JScalar, write_json(Scalar, com.r)))


@pytest.fixture(scope="module")
def hard(hardened):
    """A parameter set made by the reference with both flags on, carried
    to the port, and the port's device parameters of it (the plain comb
    versions on the CPU)."""
    with jrng.deterministic(91):
        jparams = jgenerate_params()
    tparams = carry.params_from_jax(jwrite_json(JParams, jparams))
    return jparams, tparams, device_params_for(tparams, "cpu")


def test_hardened_pedersen_params(hardened):
    """tests/test_hardened.py:57 on the port: h is the hash-to-curve point
    of g, commitments open, the wire round-trips; and the port's params
    are the reference's bytes (the flag leaves no randomness in them)."""
    params = generate_pedersen_params(tomEdwards256)
    assert params.h.eq(hash_to_point(tomEdwards256, params.g.to_bytes()))
    with trng.deterministic(3):
        com = params.commit(12345)
    assert com.p.eq(params.h.dblmul(com.r, params.g, tomEdwards256.new_scalar(12345)))
    sp = SystemParametersList(generate_pedersen_params(p256), params, 80)
    sp2 = read_json(SystemParametersList, write_json(SystemParametersList, sp))
    assert sp2.proof_group.h.eq(params.h)
    assert write_json(PedersenParams, params) == jwrite_json(JPedersen, jgenerate_pedersen(jtom))


def test_hardened_gk_roundtrip_and_binding(hardened):
    """tests/test_hardened.py:72 on the port, and the proof is the
    reference's bytes on the same tape."""
    params = generate_pedersen_params(tomEdwards256)
    with trng.deterministic(4):
        com = params.commit(RING[3])
    with trng.scoped(trng.DeterministicSource(41)):
        proof = prove_membership(params, com, 3, RING)
    assert verify_membership(params, com.p, RING, proof)
    assert not verify_membership(params, com.p, [3, 5, 7, 11, 17], proof)
    jparams = jgenerate_pedersen(jtom)
    with jrng.scoped(jrng.DeterministicSource(41)):
        jproof = jprove_membership(jparams, _jcommitment(com), 3, RING)
    assert write_json(GKProof, proof) == jwrite_json(JGKProof, jproof)
    _gk_unbound()
    try:
        assert not verify_membership(params, com.p, RING, proof)
    finally:
        _gk_bound()


def test_hardened_gk_batch_matches_host(hard):
    """tests/test_hardened.py:88 on the port: the batched GK prover (plain
    versions on the CPU) gives the port host prover's and the reference
    host prover's bytes under the flags, and the batched verifier accepts
    them; with ``hardened_gk`` off it rejects them."""
    jparams, tparams, dev = hard
    params = tparams.proof_group
    with trng.deterministic(5):
        coms = [params.commit(RING[i]) for i in (1, 3)]
    host, ref = [], []
    jpg = jparams.proof_group
    for k, which in enumerate((1, 3)):
        with trng.scoped(trng.DeterministicSource(100 + k)):
            host.append(prove_membership(params, coms[k], which, RING))
        with jrng.scoped(jrng.DeterministicSource(100 + k)):
            ref.append(jprove_membership(jpg, _jcommitment(coms[k]), which, RING))
    tapes = [trng.DeterministicSource(100 + k) for k in range(2)]
    proofs = batch_prove_membership(params, coms, (1, 3), RING, tapes, dev)
    wire = [write_json(GKProof, p) for p in proofs]
    assert wire == [write_json(GKProof, p) for p in host]
    assert wire == [jwrite_json(JGKProof, p) for p in ref]
    pts = [c.p for c in coms]
    assert batch_verify_membership(params, pts, RING, proofs, device="cpu") == [True, True]
    _gk_unbound()
    try:
        assert batch_verify_membership(params, pts, RING, proofs, device="cpu") == [False, False]
    finally:
        _gk_bound()


def test_hardened_device_params_equal_jax(hard):
    """The comb tables of the hardened set (h by hash-to-curve on both
    curves) equal the reference's DeviceParams tables: the Tom-256 ones
    exactly, the P-256 one as affine points (the reference's is
    projective)."""
    jparams, tparams, dev = hard
    assert tparams.nist_group.h.eq(hash_to_point(p256, tparams.nist_group.g.to_bytes()))
    assert tparams.proof_group.h.eq(hash_to_point(tomEdwards256, tparams.proof_group.g.to_bytes()))
    jtabs = jdevice_params_for(jparams).tabs()
    carried = carry.tables_from_jax({k: np.asarray(jtabs[k]) for k in ("g_t8", "h_t8", "h_n8")})
    tabs = dev.tabs()
    assert torch.equal(tabs["gh_t8"].canon, torch.cat([carried["g_t8"], carried["h_t8"]]))
    p = p256.p
    ref = [P256_P.unpack(carried["h_n8"][..., k, :]) for k in range(3)]
    port = [P256_P.unpack(tabs["h_n8"][..., k, :]) for k in range(3)]
    for X, Y, Z, x, y, z in zip(*ref, *port):
        if Z == 0:
            assert (X, x, y, z) == (0, 0, 1, 0)
        else:
            zinv = pow(Z, -1, p)
            assert (X * zinv % p, Y * zinv % p, z) == (x, y, 1)


def test_hardened_pipeline_matches_jax(hard):
    """Both flags on, N = 1, ring 4, tape 4242: the port's BatchProver
    (plain versions on the CPU) gives the reference BatchProver's bytes
    and the port host prover's; the port's BatchVerifier accepts the proof
    and rejects it with ``hardened_gk`` off; the reference's scalar
    verifier accepts it."""
    jparams, tparams, _ = hard
    with jrng.deterministic(92):
        kp = jecdsa.generate_keypair()
        msg = b"hardened"
        sig = jecdsa.sign(kp, msg)
        pub = jecdsa.export_public_raw(kp)
    mh = hashlib.sha256(msg).digest()
    ring = [jecdsa.key_to_int(pub), 11, 13, 17]
    ref = JBatchProver(jparams).prove([mh], [sig], [pub], [0], ring, [jrng.DeterministicSource(4242)])
    ref_json = jwrite_json(JProof, ref[0])
    got = BatchProver(tparams, device="cpu").prove(
        [mh], [sig], [pub], [0], ring, [trng.DeterministicSource(4242)]
    )
    wire = write_json(SignatureProofList, got[0])
    assert wire == ref_json
    with trng.scoped(trng.DeterministicSource(4242)):
        host = prove_signature_list(tparams, mh, sig, pub, 0, ring)
    assert write_json(SignatureProofList, host) == wire
    bv = BatchVerifier(tparams, device="cpu")
    with trng.deterministic(6):
        assert bv.verify([mh], ring, got) == [True]
    with jrng.deterministic(7):
        assert jverify_host(jparams, mh, ring, jread_json(JProof, wire))
    _gk_unbound()
    try:
        with trng.deterministic(6):
            assert bv.verify([mh], ring, got) == [False]
    finally:
        _gk_bound()
