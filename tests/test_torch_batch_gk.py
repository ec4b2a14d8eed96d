"""The port's batched GK membership (``zkecdsa_tpu_torch.protocol.batch_gk``)
against the JAX package's, on the CPU: the counterparts of
tests/test_batch_gk.py.  Parameters, commitments and proofs cross between
the packages on the wire (serde JSON); the port proves on the same tapes
and its verdicts must equal the JAX ``batch_verify_membership``'s on the
same proofs."""

import pytest
import torch

from zkecdsa_tpu.commit import generate_pedersen_params as jgenerate_pedersen
from zkecdsa_tpu.commit.pedersen import PedersenParams as JPedersen
from zkecdsa_tpu.curves import tomEdwards256 as jtom
from zkecdsa_tpu.curves.group import Point as JPoint
from zkecdsa_tpu.proofGK import prove_membership as jprove_membership
from zkecdsa_tpu.proofGK.gk import GKProof as JGKProof
from zkecdsa_tpu.protocol.batch_gk import batch_verify_membership as jbatch_verify
from zkecdsa_tpu.serde import write_json as jwrite_json
from zkecdsa_tpu.utils import rng as jrng
from zkecdsa_tpu_torch.commit.pedersen import Commitment, PedersenParams, generate_pedersen_params
from zkecdsa_tpu_torch.curves.group import Point, Scalar
from zkecdsa_tpu_torch.curves.instances import p256
from zkecdsa_tpu_torch.proofGK.gk import GKProof
from zkecdsa_tpu_torch.protocol.batch import DeviceParams
from zkecdsa_tpu_torch.protocol.batch_gk import batch_prove_membership, batch_verify_membership
from zkecdsa_tpu_torch.serde import read_json, write_json
from zkecdsa_tpu_torch.utils import rng as trng
from zkecdsa_tpu_torch.zkp_attest_list import SystemParametersList

# One intra-op thread: the suite runs several worker processes on the same
# cores, and an oversubscribed OpenMP pool spins instead of working.
torch.set_num_threads(1)


def _port_points(pts):
    return [read_json(Point, jwrite_json(JPoint, p)) for p in pts]


@pytest.fixture(scope="module")
def setup():
    """tests/test_batch_gk.py's setup, made by the reference, and its
    counterpart objects in the port with the device tables of the
    Pedersen parameters."""
    with jrng.deterministic(11):
        jparams = jgenerate_pedersen(jtom)
    ring = [3, 5, 7, 11, 13]  # pads to 8
    idxs = [1, 3]
    with jrng.deterministic(12):
        jcoms = [jparams.commit(ring[i]) for i in idxs]
    params = read_json(PedersenParams, jwrite_json(JPedersen, jparams))
    coms = [
        Commitment(pt, read_json(Scalar, jwrite_json(type(c.r), c.r)))
        for pt, c in zip(_port_points([c.p for c in jcoms]), jcoms)
    ]
    with trng.deterministic(13):
        nist = generate_pedersen_params(p256)
    dev = DeviceParams(SystemParametersList(nist, params, 80), "cpu")
    return jparams, jcoms, params, coms, ring, idxs, dev


def _prove_both(setup, seeds):
    """The JAX host prover's proofs and the port's batched ones on the
    same tapes."""
    jparams, jcoms, params, coms, ring, idxs, dev = setup
    host = []
    for k, seed in enumerate(seeds):
        with jrng.scoped(jrng.DeterministicSource(seed)):
            host.append(jprove_membership(jparams, jcoms[k], idxs[k], ring))
    tapes = [trng.DeterministicSource(s) for s in seeds]
    batch = batch_prove_membership(params, coms[: len(seeds)], idxs[: len(seeds)], ring, tapes, dev)
    return host, batch


def test_batched_gk_bit_identical(setup):
    jparams, jcoms, params, coms, ring, _, _ = setup
    host, batch = _prove_both(setup, [500, 501])
    assert [write_json(GKProof, p) for p in batch] == [jwrite_json(JGKProof, p) for p in host]
    want = jbatch_verify(jparams, [c.p for c in jcoms], ring, host)
    assert want == [True, True]
    assert batch_verify_membership(params, [c.p for c in coms], ring, batch, device="cpu") == want


def test_batched_gk_rejects_wrong_commitment(setup):
    jparams, _, params, _, ring, _, _ = setup
    host, batch = _prove_both(setup, [600, 601])
    with jrng.deterministic(14):
        jbad = [jparams.commit(999).p for _ in range(2)]
    want = jbatch_verify(jparams, jbad, ring, host)
    assert want == [False, False]
    assert batch_verify_membership(params, _port_points(jbad), ring, batch, device="cpu") == want


def test_batched_gk_rejects_truncated(setup):
    jparams, jcoms, params, coms, ring, _, _ = setup
    host, batch = _prove_both(setup, [700])
    host[0].cl = host[0].cl[:-1]
    batch[0].cl = batch[0].cl[:-1]
    want = jbatch_verify(jparams, [jcoms[0].p], ring, host)
    assert want == [False]
    assert batch_verify_membership(params, [coms[0].p], ring, batch, device="cpu") == want
