"""The port's batched verifier (``zkecdsa_tpu_torch.protocol.batch_verify``)
against the JAX package's, end to end on the CPU.

Parameters and proofs are made by the reference and cross to the port on
the wire (``carry.params_from_jax``, serde JSON).  Both packages draw the
verifier's randomness (the 20-of-80 round sample, the combined check's
r_i) from their own ``rng``; every test enters both.
"""

import dataclasses
import gc
import hashlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zkecdsa_tpu import ecdsa as jecdsa
from zkecdsa_tpu.curves.instances import p256 as jp256
from zkecdsa_tpu.curves.instances import tomEdwards256 as jtom
from zkecdsa_tpu.ops.curve_ops import nibble_digits as jnibbles
from zkecdsa_tpu.ops.curve_ops import p256_ops as jp256_ops
from zkecdsa_tpu.ops.f32field import TOM_N as JTOM_N
from zkecdsa_tpu.ops.f32field import P256_P as JP256_P
from zkecdsa_tpu.ops.f32field import TOM_P as JTOM_P
from zkecdsa_tpu.protocol import batch_verify as jbv
from zkecdsa_tpu.protocol.batch import _pk_scalars as jpk_scalars
from zkecdsa_tpu.protocol.batch import device_params_for as jax_device_params_for
from zkecdsa_tpu.serde import read_json as jread_json
from zkecdsa_tpu.serde import write_json as jwrite_json
from zkecdsa_tpu.utils import config as jconfig
from zkecdsa_tpu.utils import rng as jrng
from zkecdsa_tpu.zkp_attest_list import SignatureProofList as JProof
from zkecdsa_tpu.zkp_attest_list import SystemParametersList as JParams
from zkecdsa_tpu.zkp_attest_list import generate_params_list as jgenerate_params
from zkecdsa_tpu.zkp_attest_list import prove_signature_list as jprove
from zkecdsa_tpu.zkp_attest_list import verify_signature_list as jverify_host
from zkecdsa_tpu_torch import carry
from zkecdsa_tpu_torch.curves.instances import p256
from zkecdsa_tpu_torch.ops import curve_ops as tcurve
from zkecdsa_tpu_torch.ops.field import P256_P, TOM_P
from zkecdsa_tpu_torch.protocol import batch_verify as tbv
from zkecdsa_tpu_torch.protocol.batch import DeviceParams
from zkecdsa_tpu_torch.serde import read_json, write_json
from zkecdsa_tpu_torch.utils import config as tconfig
from zkecdsa_tpu_torch.utils import profiling as tprofiling
from zkecdsa_tpu_torch.utils import rng as trng
from zkecdsa_tpu_torch.utils.profiling import StageTimer
from zkecdsa_tpu_torch.zkp_attest_list import SignatureProofList

# One intra-op thread: the suite runs several worker processes on the same
# cores, and an oversubscribed OpenMP pool spins instead of working.
torch.set_num_threads(1)

S = 20  # verify rounds


@pytest.fixture(autouse=True)
def port_rng():
    with trng.deterministic(0xC0FFEE):
        yield


def _to_port(proof) -> SignatureProofList:
    return read_json(SignatureProofList, jwrite_json(JProof, proof))


def test_vphase_matches_reference():
    rs = np.random.RandomState(81)
    with jrng.deterministic(22):
        jparams = jgenerate_params()
    tparams = carry.params_from_jax(jwrite_json(JParams, jparams))
    R_h = jp256.generator().mul(jp256.new_scalar(int.from_bytes(rs.bytes(32), "big") % jp256.order))
    n = jp256.order
    z1 = int.from_bytes(rs.bytes(32), "big") % n
    ms = [int.from_bytes(rs.bytes(32), "big") % n for _ in range(S)]
    bits = rs.randint(0, 2, size=(1, S)).astype(bool)
    rb = [int.from_bytes(rs.bytes(32), "big") % jtom.order for _ in range(2 * S)]

    ref = jbv._VPHASE(
        jax_device_params_for(jparams).tabs(),
        jnp.asarray(jp256_ops.pack_points([R_h])),
        jnp.asarray(jnibbles([z1])),
        jnp.asarray(jnibbles(ms).reshape(1, S, 64)),
        jnp.asarray(bits),
        jpk_scalars(JTOM_N, rb).reshape(1, S, 2, -1),
    )
    u8 = lambda a: torch.from_numpy(np.ascontiguousarray(a, dtype=np.uint8))  # noqa: E731
    got = tbv.vphase(
        DeviceParams(tparams, "cpu").tabs(),
        tcurve.p256_ops.pack_points([_to_port_point(R_h)]),
        u8(tcurve.nibble_digits([z1])),
        u8(tcurve.nibble_digits(ms).reshape(1, S, 64)),
        torch.from_numpy(bits),
        u8(tcurve.byte_digits(rb).reshape(1, S, 2, 32)),
    )
    for key, fields in (("T0_aff", (P256_P, JP256_P)), ("coord", (P256_P, JP256_P)),
                        ("com_aff", (TOM_P, JTOM_P))):
        tf_, jf_ = fields
        for k in range(2):
            assert tf_.unpack(got[key][k]) == jf_.unpack_canonical(np.asarray(ref[key][k])), key
        if key != "com_aff":
            assert got[key][2].tolist() == np.asarray(ref[key][2]).tolist()


def _to_port_point(pt):
    """A reference P-256 point as the port's (same coordinates)."""
    from zkecdsa_tpu_torch.curves.weier import WeierstrassPoint

    return WeierstrassPoint(p256, pt.x, pt.y, pt.z)


@pytest.fixture(scope="module")
def gate():
    """The shape of tests/test_pipeline_gate.py: one proof, ring of 4."""
    with jrng.deterministic(77):
        params = jgenerate_params()
        kp = jecdsa.generate_keypair()
        msg = b"gate"
        sig = jecdsa.sign(kp, msg)
        pub = jecdsa.export_public_raw(kp)
        mh = hashlib.sha256(msg).digest()
        ring = [jecdsa.key_to_int(pub), 11, 13, 17]
    with jrng.scoped(jrng.DeterministicSource(4242)):
        proof = jprove(params, mh, sig, pub, 0, ring)
    return params, mh, ring, proof


def test_batch_verifier_matches_reference(gate):
    params, mh, ring, proof = gate
    tparams = carry.params_from_jax(jwrite_json(JParams, params))
    tproof = _to_port(proof)
    bad = hashlib.sha256(b"tampered").digest()
    port = tbv.BatchVerifier(tparams, device="cpu")
    timer = StageTimer("cpu")
    with jrng.deterministic(5), trng.deterministic(5):
        got = [port.verify([mh], ring, [tproof], timer=timer), port.verify([bad], ring, [tproof])]
        ref = [jbv.BatchVerifier(params).verify([m], ring, [proof]) for m in (mh, bad)]
    assert got == ref == [[True], [False]]
    assert port.verify([], ring, []) == []
    assert {"verify.device", "verify.gk_recombine", "msm.device"} <= set(timer.stages)


@pytest.fixture(scope="module")
def mixed():
    """Two signers in a ring of 4, one proof each (the shape of
    test_batch_verify.py's mixed-batch tests)."""
    with jrng.deterministic(11):
        params = jgenerate_params()
        kps = [jecdsa.generate_keypair() for _ in range(2)]
        pubs = [jecdsa.export_public_raw(kp) for kp in kps]
        ring = [jecdsa.key_to_int(p) for p in pubs] + [21, 22]
        msgs = [hashlib.sha256(f"mixed {i}".encode()).digest() for i in range(2)]
        proofs = [
            jprove(params, msgs[i], jecdsa.sign(kps[i], f"mixed {i}".encode()), pubs[i], i, ring)
            for i in range(2)
        ]
    return params, msgs, ring, proofs


def _host_verdicts(params, msgs, ring, proofs) -> list[bool]:
    out = []
    for m, p in zip(msgs, proofs):
        try:
            out.append(bool(jverify_host(params, m, ring, p)))
        except (ValueError, IndexError):  # a malformed proof raises on the host path
            out.append(False)
    return out


def test_mixed_batch_combined_and_attribution(mixed, monkeypatch):
    """Honest, tampered-GK and truncated-exp instances: per-instance
    verdicts equal the reference host verifier's.  With the port's
    _COMB_W shrunk the Tom-256 check takes the combined path, and a
    failure there runs the per-row attribution."""
    params, msgs, ring, jproofs = mixed
    monkeypatch.setattr(tbv, "_COMB_W", 64)
    tparams = carry.params_from_jax(jwrite_json(JParams, params))
    port = tbv.BatchVerifier(tparams, device="cpu")

    honest = [_to_port(p) for p in jproofs]
    tampered = [_to_port(p) for p in jproofs]
    tampered[1].membershipProof.f[0] = tampered[1].membershipProof.f[1]
    truncated = [_to_port(p) for p in jproofs]
    truncated[0].expProof = truncated[0].expProof[:10]

    cases = [
        (honest, [True, True]),
        (tampered, [True, False]),
        (truncated, [False, True]),
    ]
    for k, (batch, want) in enumerate(cases):
        timer = StageTimer("cpu")
        with trng.deterministic(100 + k):
            got = port.verify(msgs, ring, batch, timer=timer)
        assert got == want, k
        # the reference host verifier, per instance, on the same proofs
        ref_proofs = [jread_json(JProof, write_json(SignatureProofList, p)) for p in batch]
        with jrng.deterministic(200 + k):
            assert _host_verdicts(params, msgs, ring, ref_proofs) == want, k
        if k < 2:
            # Tom-256 takes the combined check; the per-row path runs for
            # P-256, and for Tom-256 again when the combined check fails
            assert timer.counts.get("msm.combine_host") == 1, timer.counts
            assert timer.counts.get("msm.pack_host") == 1 + k, timer.counts
        # that rerun is the attribution pass, one span with its rows counted
        assert timer.counts.get("msm.attribution", 0) == (1 if k == 1 else 0), timer.counts
        if k == 1:
            assert timer.counters[("msm.attribution", "msm.attribution_rows")] == 2
            assert timer.counters[("msm.attribution", "msm.rows_failed")] == 1


def test_mixed_batch_spans_and_counters(mixed, monkeypatch):
    """The tampered batch under ``profiling.tracing`` with no ``timer=``:
    the verifier's stages nest as they should under one call id, the
    per-row checks of the attribution pass inside ``msm.attribution``;
    the round sample's draws are counted in ``verify.host_prep`` (78
    ``rnd`` calls a proof, the shuffle of 80 rounds); ``verify.assemble``
    counts both proofs, 6 challenges a bit-0 round and an ``rnd`` call a
    weight, one a relation (2n + 1 GK relations, 3 a sampled bit-1 round,
    25 a bit-0 round); a seeded source moves no OS counter.  Then, with no
    tracer, a verify adds no collector callback and moves no tally."""
    params, msgs, ring, jproofs = mixed
    monkeypatch.setattr(tbv, "_COMB_W", 64)
    port = tbv.BatchVerifier(carry.params_from_jax(jwrite_json(JParams, params)), device="cpu")
    tampered = [_to_port(p) for p in jproofs]
    tampered[1].membershipProof.f[0] = tampered[1].membershipProof.f[1]
    timer = StageTimer("cpu")
    with tprofiling.tracing(timer):
        assert port.verify(msgs, ring, tampered) == [True, False]
    assert tprofiling.TRACER is None
    by_id = {sp.id: sp for sp in timer.spans}
    assert len({sp.call for sp in timer.spans}) == 1 and None not in {sp.call for sp in timer.spans}
    (attr,) = [sp for sp in timer.spans if sp.name == "msm.attribution"]
    assert attr.parent is None
    inside = [sp.name for sp in timer.spans if sp.parent == attr.id]
    assert inside == ["msm.pack_host", "msm.upload", "msm.digits", "msm.device"]
    assert all(sp.parent is None for sp in timer.spans if sp.name.startswith("verify."))
    assert all(by_id[sp.parent].name == "msm.attribution" for sp in timer.spans if sp.parent is not None)
    assert timer.counters[("verify.host_prep", "rnd.calls")] == 2 * 78
    asm = {name: v for (span, name), v in timer.counters.items() if span == "verify.assemble"}
    n = 2  # ring of 4
    bit0 = asm["assemble.hashes"] // 6
    assert asm["assemble.hashes"] == 6 * bit0 and 0 < bit0 < 2 * S
    assert asm["assemble.proofs"] == 2
    assert asm["rnd.calls"] == asm["rnd.draws"] == 2 * (2 * n + 1) + 3 * (2 * S - bit0) + 25 * bit0
    assert not any(name.startswith("rng.os") for _, name in timer.counters)

    before = list(gc.callbacks)
    assert port.verify(msgs, ring, tampered) == [True, False]
    assert gc.callbacks == before and tprofiling.TRACER is None
    assert all(not any(t.values) for t in tprofiling._tallies)


def test_assembly_draws_its_weights_in_one_os_call(mixed, monkeypatch):
    """Under the OS's source every weight of a batch comes from one call
    inside ``verify.assemble``, and the verdicts stay."""
    params, msgs, ring, jproofs = mixed
    monkeypatch.setattr(tbv, "_COMB_W", 64)
    port = tbv.BatchVerifier(carry.params_from_jax(jwrite_json(JParams, params)), device="cpu")
    tampered = [_to_port(p) for p in jproofs]
    tampered[1].membershipProof.f[0] = tampered[1].membershipProof.f[1]
    timer = StageTimer("cpu")
    with trng.scoped(trng.RandomSource()), tprofiling.tracing(timer):
        assert port.verify(msgs, ring, tampered) == [True, False]
    asm = {name: v for (span, name), v in timer.counters.items() if span == "verify.assemble"}
    assert asm["rng.os_calls"] == 1
    assert asm["rng.os_bytes"] == 32 * asm["rnd.calls"]


@pytest.fixture
def bucket_config():
    """pippenger_min_t = 32 and 2 verify rounds in both packages for the
    test, then restored.  With 2 sampled rounds the Tom-256 row of a proof
    has at most 85 terms, so its MSM takes the bucket backend at T >= 32
    (the P-256 row, 7 terms, stays on Straus); the bucket kernels' own
    parity with the reference is in tests/test_torch_msm.py."""
    t_old, j_old = tconfig.get_config(), jconfig.get_config()
    tconfig.set_config(dataclasses.replace(t_old, pippenger_min_t=32, verify_rounds=2))
    jconfig.set_config(dataclasses.replace(j_old, pippenger_min_t=32, verify_rounds=2))
    try:
        yield
    finally:
        tconfig.set_config(t_old)
        jconfig.set_config(j_old)


def test_batch_verifier_on_bucket_backend(gate, bucket_config, monkeypatch):
    """On a batch of the honest proof and its tampered twin the bucket
    backend gives the reference's verdicts under the same config (the
    reference runs them one at a time) and those of the port's own Straus
    path."""
    params, mh, ring, proof = gate
    tparams = carry.params_from_jax(jwrite_json(JParams, params))
    seen = []
    real = tbv.bucket_sums

    def spy(ops, points, digits, window):
        seen.append((ops.group.name, tuple(points.shape[:2])))
        return real(ops, points, digits, window)

    monkeypatch.setattr(tbv, "bucket_sums", spy)
    bad = _to_port(proof)
    bad.membershipProof.f[0] = bad.membershipProof.f[1]
    batch = [_to_port(proof), bad]
    port = tbv.BatchVerifier(tparams, device="cpu")
    with trng.deterministic(60):
        got = port.verify([mh, mh], ring, batch)
    assert len(seen) == 1 and seen[0][0] == "tomEdwards256" and seen[0][1][1] >= 32, seen
    jbad = jread_json(JProof, write_json(SignatureProofList, bad))
    with jrng.deterministic(61):
        ref = [jbv.BatchVerifier(params).verify([mh], ring, [p])[0] for p in (proof, jbad)]
    seen.clear()
    tconfig.set_config(dataclasses.replace(tconfig.get_config(), pippenger_min_t=0))
    with trng.deterministic(62):
        straus = port.verify([mh, mh], ring, batch)
    assert seen == []
    assert got == ref == straus == [True, False]


@pytest.fixture(scope="module")
def ring_of_one():
    """One signer whose key is the whole ring (n = 0 index bits), proved by
    the port's host prover."""
    from zkecdsa_tpu_torch import ecdsa
    from zkecdsa_tpu_torch.zkp_attest_list import generate_params_list, prove_signature_list

    with trng.deterministic(5):
        params = generate_params_list()
        kp = ecdsa.generate_keypair()
        msg = b"ring of one"
        sig = ecdsa.sign(kp, msg)
        pub = ecdsa.export_public_raw(kp)
    key = ecdsa.key_to_int(pub)
    mh = hashlib.sha256(msg).digest()
    with trng.scoped(trng.DeterministicSource(77)):
        proof = prove_signature_list(params, mh, sig, pub, 0, [key])
    return params, mh, key, proof


def test_ring_of_one_key(ring_of_one):
    """A ring of one key: the batched verifier and ``batch_verify_membership``
    give the verdicts of the JAX package's host verifier and of the
    port's on the same parameters, key and proof (the JAX BatchVerifier
    raises here, a reference fault the port does not copy)."""
    from zkecdsa_tpu_torch.protocol.batch_gk import batch_verify_membership
    from zkecdsa_tpu_torch.zkp_attest_list import SystemParametersList, verify_signature_list

    params, mh, key, proof = ring_of_one
    bad = hashlib.sha256(b"another message").digest()
    jparams = jread_json(JParams, write_json(SystemParametersList, params))
    jproof = jread_json(JProof, write_json(SignatureProofList, proof))
    with jrng.deterministic(6):
        ref = [jverify_host(jparams, m, [key], jproof) for m in (mh, bad)]
    assert ref == [True, False]
    with trng.deterministic(6):
        host = [verify_signature_list(params, m, [key], proof) for m in (mh, bad)]
    assert host == ref
    with trng.deterministic(7):
        got = tbv.BatchVerifier(params, device="cpu").verify([mh, bad], [key], [proof, proof])
    assert got == ref
    mp = proof.membershipProof
    assert len(mp.f) == 0
    wrong = params.proof_group.commit(key + 1).p
    assert batch_verify_membership(
        params.proof_group, [proof.keyXcom, wrong], [key], [mp, mp], device="cpu"
    ) == [True, False]
