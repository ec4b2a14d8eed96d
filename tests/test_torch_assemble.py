"""The batch verifier's flat assembly (``protocol/batch_assemble.py``)
against the JAX package's object path, on the CPU.

Each case runs the port's ``BatchVerifier.verify`` on wire proofs with the
assembler spied on; its verdicts must be the JAX package's host verifier's
(``verify_signature_list``).  Then the assembler's inputs, from the source
state it was called in, go both to the flat assembler and to the JAX
package's ``MultiMult`` assembly (what its ``BatchVerifier._verify`` does
with them: the known points, ``aggregate_membership``, ``_aggregate_exp``,
on the JAX package's reading of the same wire).  The rows must hold the
same points in the same order with the same scalars (a negated term as the
un-negated point with the negated scalar), and both must draw the same
bytes from their ``DeterministicSource``.
"""

import hashlib
import json
import random

import pytest
import torch

from test_torch_verify import _host_verdicts, _to_port, mixed, ring_of_one  # noqa: F401 (fixtures)
from zkecdsa_tpu.curves.instances import p256 as jp256
from zkecdsa_tpu.curves.multimult import MultiMult as JMultiMult
from zkecdsa_tpu.protocol import batch_verify as jbv
from zkecdsa_tpu.protocol.batch_gk import aggregate_membership as jaggregate_membership
from zkecdsa_tpu.serde import read_json as jread_json
from zkecdsa_tpu.serde import write_json as jwrite_json
from zkecdsa_tpu.utils import rng as jrng
from zkecdsa_tpu.zkp_attest_list import SignatureProofList as JProof
from zkecdsa_tpu.zkp_attest_list import SystemParametersList as JParams
from zkecdsa_tpu_torch import carry
from zkecdsa_tpu_torch.curves.instances import p256, tomEdwards256
from zkecdsa_tpu_torch.protocol import batch_assemble as tasm
from zkecdsa_tpu_torch.protocol import batch_verify as tbv
from zkecdsa_tpu_torch.serde import read_json, write_json
from zkecdsa_tpu_torch.utils import rng as trng
from zkecdsa_tpu_torch.zkp_attest_list import SignatureProofList, SystemParametersList

# One intra-op thread: the suite runs several worker processes on the same
# cores, and an oversubscribed OpenMP pool spins instead of working.
torch.set_num_threads(1)


class _Recording:
    """A source whose bytes are kept, in order, with its snapshots."""

    def __init__(self, source) -> None:
        self.source = source
        self.kept = []

    def random_bytes(self, n):
        out = self.source.random_bytes(n)
        self.kept.append(out)
        return out

    def state(self):
        return self.source.state(), len(self.kept)

    def restore(self, snap):
        state, k = snap
        self.source.restore(state)
        del self.kept[k:]

    def stream(self) -> bytes:
        return b"".join(self.kept)


def jax_rows(jparams, jproofs, ok, n, gk_x, totals, idxs, bits, *dev):
    """The JAX package's object path on the assembler's inputs: one
    ``MultiMult`` a proof and curve, filled as its ``BatchVerifier._verify``
    fills them (an empty pair for a proof not ``ok``)."""
    jv = object.__new__(jbv.BatchVerifier)  # _aggregate_exp reads only the params
    jv.params = jparams
    pg, h_n = jparams.proof_group, jparams.nist_group.h
    rows_w, rows_n = [], []
    for i, proof in enumerate(jproofs):
        multiW, multiN = JMultiMult(pg.c), JMultiMult(jp256)
        if ok[i]:
            multiW.add_known(pg.g)
            multiW.add_known(pg.h)
            for P in (proof.R, h_n, proof.comS1):
                multiN.add_known(P)
            jaggregate_membership(pg, proof.keyXcom, n, proof.membershipProof, gk_x[i], totals[i], multiW)
            if not jv._aggregate_exp(proof, i, multiW, multiN, idxs[i], bits[i], *dev):
                ok[i] = False
                multiW, multiN = JMultiMult(pg.c), JMultiMult(jp256)
        rows_w.append(multiW.pairs())
        rows_n.append(multiN.pairs())
    return rows_w, rows_n


def _same_rows(flat, ref, order) -> None:
    """Row by row, position by position: the same point (by its encoding)
    and scalar, or the negated point with the negated scalar."""
    assert len(flat) == len(ref)
    for (fp, fs), (rp, rs) in zip(flat, ref):
        assert len(fp) == len(rp) == len(fs) == len(rs)
        for P, s, Q, t in zip(fp, fs, rp, rs):
            assert 0 <= s < order
            q = Q.to_bytes()
            assert (P.to_bytes() == q and s == t) or (P.neg().to_bytes() == q and s == (-t) % order)


def _spy(monkeypatch):
    """Keeps the assembler's inputs, the ``ok`` it got, the source's state
    at its call, and its rows."""
    seen = []
    real = tasm.assemble_rows

    def spy(params, proofs, ok, *rest):
        call = {"ok": list(ok), "rest": rest, "state": trng.get_source().state()}
        call["rows"] = real(params, proofs, ok, *rest)
        seen.append(call)
        return call["rows"]

    monkeypatch.setattr(tbv, "assemble_rows", spy)
    return seen


def _check(seed, tparams, jparams, tproofs, jproofs, calls) -> None:
    """Each spied call assembled again, flat and by the JAX package's
    object path, from the state it was made in: the same rows, ``ok`` and
    bytes drawn; the flat ones also those the verifier used."""
    assert calls
    for call in calls:
        out = []
        for fn, rng_, proofs, params in ((tasm.assemble_rows, trng, tproofs, tparams),
                                         (jax_rows, jrng, jproofs, jparams)):
            src = _Recording(rng_.DeterministicSource(seed))
            src.source.restore(call["state"])
            oks = list(call["ok"])
            with rng_.scoped(src):
                rows = fn(params, proofs, oks, *call["rest"])
            out.append((rows, oks, src.stream()))
        ((fw, fn_), f_ok, f_drawn), ((jw, jn), j_ok, j_drawn) = out
        _same_rows(fw, call["rows"][0], tomEdwards256.order)
        _same_rows(fn_, call["rows"][1], p256.order)
        _same_rows(fw, jw, tomEdwards256.order)
        _same_rows(fn_, jn, p256.order)
        assert f_ok == j_ok
        assert f_drawn == j_drawn and len(f_drawn) > 0


def _edit(text: str, fn) -> str:
    obj = json.loads(text)
    fn(obj)
    return json.dumps(obj)


def _plus_p(obj) -> None:
    """Every point-addition proof's ``pi_8.A_x`` with x + p, its ``C_8``
    with y + p: the same points, coordinates the native decoder declines
    and the Python path keeps unreduced."""
    p = tomEdwards256.p
    for rp in obj["expProof"]:
        if "proof" in rp:
            for pt, c in ((rp["proof"]["pi_8"]["A_x"], "x"), (rp["proof"]["C_8"], "y")):
                pt[c] = f"0x{int(pt[c], 16) + p:x}"


@pytest.mark.parametrize(
    "case", ["honest", "gk_tampered", "truncated", "exp_tampered", "point_add_tampered", "x_plus_p"]
)
def test_flat_rows_are_the_object_paths(mixed, monkeypatch, case):  # noqa: F811 (fixture)
    """The ``mixed`` batch of ``test_torch_verify.py`` (two signers in a
    ring of 4, n = 2), honest and tampered as there, with a response
    changed in every round of one proof (in its P-256 row, in its Tom-256
    row), and with wire coordinates at or above p: the verdicts of the JAX
    package's host verifier, the rows and draws of its object path."""
    params, msgs, ring, jproofs = mixed
    monkeypatch.setattr(tbv, "_COMB_W", 64)
    tparams = carry.params_from_jax(jwrite_json(JParams, params))
    batch = [_to_port(p) for p in jproofs]
    want = [True, True]
    if case == "gk_tampered":
        batch[1].membershipProof.f[0] = batch[1].membershipProof.f[1]
        want = [True, False]
    elif case == "truncated":
        batch[0].expProof = batch[0].expProof[:10]
        want = [False, True]
    elif case == "exp_tampered":  # every round's relA: the P-256 row
        for rp in batch[0].expProof:
            if rp.z2 is not None:
                rp.z2 = p256.new_scalar(rp.z2.k + 1)
            if rp.beta1 is not None:
                rp.beta1 = p256.new_scalar(rp.beta1.k + 1)
        want = [False, True]
    elif case == "point_add_tampered":  # every bit-0 round's pi_8: the Tom-256 row
        for rp in batch[1].expProof:
            if rp.proof is not None:
                rp.proof.pi_8.t_x = tomEdwards256.new_scalar(rp.proof.pi_8.t_x.k + 1)
        want = [True, False]
    texts = [write_json(SignatureProofList, p) for p in batch]
    if case == "x_plus_p":
        texts[1] = _edit(texts[1], _plus_p)
        batch[1] = read_json(SignatureProofList, texts[1])
        assert any(rp.proof.pi_8.A_x.x >= tomEdwards256.p for rp in batch[1].expProof if rp.proof)
    ref_proofs = [jread_json(JProof, t) for t in texts]
    with jrng.deterministic(200 + len(case)):
        assert _host_verdicts(params, msgs, ring, ref_proofs) == want
    seen = _spy(monkeypatch)
    seed = 300 + len(case)
    with trng.deterministic(seed):
        got = tbv.BatchVerifier(tparams, device="cpu").verify(msgs, ring, batch)
    assert got == want
    _check(seed, tparams, params, batch, ref_proofs, seen)


def test_flat_rows_at_a_ring_of_one_key(ring_of_one, monkeypatch):  # noqa: F811 (fixture)
    """A ring of one key (n = 0: the GK rows hold only the final
    relation), honest and with another message: the rows and draws of the
    JAX package's object path."""
    params, mh, key, proof = ring_of_one
    bad = hashlib.sha256(b"another message").digest()
    jparams = jread_json(JParams, write_json(SystemParametersList, params))
    jproof = jread_json(JProof, write_json(SignatureProofList, proof))
    seen = _spy(monkeypatch)
    with trng.deterministic(41):
        got = tbv.BatchVerifier(params, device="cpu").verify([mh, bad], [key], [proof, proof])
    assert got == [True, False]
    _check(41, params, jparams, [proof, proof], [jproof, jproof], seen)


@pytest.mark.parametrize("field", ["point", "scalar"])
def test_a_value_of_the_other_curve_fails_its_proof_alone(mixed, monkeypatch, field):  # noqa: F811 (fixture)
    """A proof whose every ``pi_8`` holds a P-256 ``A_x`` (a P-256
    ``t_x``), as the wire may name it: that proof fails, as the JAX
    package's host verifier fails it, with empty rows; the other stands."""
    params, msgs, ring, jproofs = mixed
    tparams = carry.params_from_jax(jwrite_json(JParams, params))
    batch = [_to_port(p) for p in jproofs]
    for rp in batch[1].expProof:
        if rp.proof is not None:
            if field == "point":
                rp.proof.pi_8.A_x = p256.generator()
            else:
                rp.proof.pi_8.t_x = p256.new_scalar(rp.proof.pi_8.t_x.k)
    batch[1] = read_json(SignatureProofList, write_json(SignatureProofList, batch[1]))
    ref_proofs = [jread_json(JProof, write_json(SignatureProofList, p)) for p in batch]
    with jrng.deterministic(9):
        assert _host_verdicts(params, msgs, ring, ref_proofs) == [True, False]
    seen = _spy(monkeypatch)
    with trng.deterministic(9):
        assert tbv.BatchVerifier(tparams, device="cpu").verify(msgs, ring, batch) == [True, False]
    ((rows_w, rows_n),) = [call["rows"] for call in seen]
    assert rows_w[1] == rows_n[1] == ([], []) and rows_w[0][0] and rows_n[0][0]


def test_affine_encodings_are_to_bytes():
    """The affine points of one batch inversion encode as ``to_bytes()``
    encodes the projective points (Z != 1), a zero Z as ``big.inv_mod``'s
    0 does; points with Z = 1, as read from the wire, encode with no
    inversion, coordinates at or above p reduced."""
    rnd = random.Random(23)
    g = tomEdwards256.generator()
    p = tomEdwards256.p
    pts = [g.mul(tomEdwards256.new_scalar(rnd.randrange(1, tomEdwards256.order))) for _ in range(9)]
    pts.append(pts[0].add(pts[1]).add(pts[2]))
    assert all(P.z != 1 for P in pts)
    fb = tomEdwards256.size_field_bytes()
    aff = tasm.affine_points(tomEdwards256, [(P.x, P.y, P.z) for P in pts])
    assert [tasm.encode(A, p, fb) for A in aff] == [P.to_bytes() for P in pts]
    assert all(A.z == 1 and A.eq(P) for A, P in zip(aff, pts))
    wire = [tomEdwards256.deserialize_point(P.to_bytes()) for P in pts]
    assert all(W.z == 1 for W in wire)
    assert [tasm.encode(W, p, fb) for W in wire] == [P.to_bytes() for P in pts]
    for W in wire:
        W.x, W.y = W.x + p, W.y + 2 * p
    assert [tasm.encode(W, p, fb) for W in wire] == [W.to_bytes() for W in wire] == [P.to_bytes() for P in pts]
    zero = tomEdwards256.identity()
    zero.x, zero.y, zero.z = 5, 7, 0
    mixed_in = [(P.x, P.y, P.z) for P in pts[:3]] + [(5, 7, 0)] + [(P.x, P.y, P.z) for P in pts[3:]]
    got = tasm.affine_points(tomEdwards256, mixed_in)
    assert tasm.encode(got[3], p, fb) == zero.to_bytes()
    assert [tasm.encode(A, p, fb) for A in got[:3] + got[4:]] == [P.to_bytes() for P in pts]
