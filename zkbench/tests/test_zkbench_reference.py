"""The plain reference (``zkbench/reference``): it reproduces the frozen
golden wire vectors in ``tests/vectors/`` (read only); on a small ring it
rejects each tampering kind the verify mixes make, the one-round kind
exactly where its draws sample that round; and the draws it replays for
each slot are the ones the port's verifier sampled that slot's rounds
with."""

import dataclasses
import hashlib
import json
import os
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from zkbench.harness import traffic  # noqa: E402
from zkbench.harness.check import Replay, reference_verify, slot_draws  # noqa: E402
from zkbench.reference import ecdsa, serde  # noqa: E402
from zkbench.reference import zkp_attest_list as zk  # noqa: E402
from zkbench.reference.utils import config, rng  # noqa: E402

VEC = ROOT / "tests" / "vectors"


@pytest.fixture(autouse=True)
def wire_defaults():
    config.set_config(config.Config())
    yield
    config.set_config(config.Config())


def test_reference_imports_nothing_of_the_port_or_jax():
    import subprocess

    code = ("import sys; sys.path.insert(0, %r); import zkbench.reference.serde, zkbench.reference.ecdsa; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & {'jax', 'jaxlib', 'flax', 'zkecdsa_tpu', "
            "'zkecdsa_tpu_torch', 'torch'}))" % str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "[]"


def test_golden_params_and_proof_reproduce_byte_exact():
    inputs = json.loads((VEC / "golden_inputs.json").read_text())
    with rng.deterministic(inputs["params_seed"]):
        params = zk.generate_params_list()
        kp = ecdsa.generate_keypair()
        pub = ecdsa.export_public_raw(kp)
    assert pub.hex() == inputs["pub_hex"]
    assert serde.write_json(zk.SystemParametersList, params) == (VEC / "golden_params.json").read_text()
    params = serde.read_json(zk.SystemParametersList, (VEC / "golden_params.json").read_text())
    ring = [int(v, 16) for v in inputs["ring"]]
    with rng.deterministic(inputs["tape_seed"]):
        proof = zk.prove_signature_list(
            params, bytes.fromhex(inputs["msg_hash_hex"]), bytes.fromhex(inputs["sig_hex"]),
            bytes.fromhex(inputs["pub_hex"]), inputs["which"], ring,
        )
    assert serde.write_json(zk.SignatureProofList, proof) == (VEC / "golden_proof.json").read_text()


@pytest.fixture(scope="module")
def small_ring_proof():
    cfg = traffic.Config(name="t", ring=16, sec_level=80, verify_rounds=20, hardened_pedersen=0, hardened_gk=0)
    inst = traffic.make_instances(cfg, 2, seed=7)
    params = serde.read_json(zk.SystemParametersList, inst.params_json)
    with rng.deterministic(b"tape"):
        proof = zk.prove_signature_list(params, inst.msg_hashes[0], inst.sigs[0], inst.pubs[0], inst.whichs[0], inst.ring)
    wire = serde.write_json(zk.SignatureProofList, proof)
    job = dict(cfg=dataclasses.asdict(cfg),
               params_json=inst.params_json, msg_hash=inst.msg_hashes[0], ring=inst.ring, rounds=20,
               draws=os.urandom(8192))
    return wire, job


def test_instances_are_signed_and_in_the_ring():
    cfg = traffic.Config(name="t", ring=16, sec_level=80, verify_rounds=20, hardened_pedersen=0, hardened_gk=0)
    inst = traffic.make_instances(cfg, 3, seed=7)
    from zkbench.reference.curves.instances import p256

    for i in range(3):
        key = p256.deserialize_point(inst.pubs[i])
        assert inst.ring[inst.whichs[i]] == ecdsa.key_to_int(inst.pubs[i])
        n = p256.order  # the ECDSA equation on the signed hash
        r, s = int.from_bytes(inst.sigs[i][:32], "big"), int.from_bytes(inst.sigs[i][32:], "big")
        z = ecdsa._truncate_hash(inst.msg_hashes[i])
        w = pow(s, -1, n)
        R = p256.generator().mul(p256.new_scalar(z * w % n)).add(key.mul(p256.new_scalar(r * w % n)))
        assert R.to_affine()[0] % n == r
    assert len(set(inst.whichs)) == 3
    assert traffic.make_instances(cfg, 3, seed=7) == inst
    assert traffic.make_instances(cfg, 3, seed=8) != inst


def test_reference_accepts_the_valid_proof(small_ring_proof):
    wire, job = small_ring_proof
    assert reference_verify(dict(job, wire=wire))


def sampled(draws: bytes, rounds: int = 20) -> list[int]:
    """The rounds the reference's verifier checks with these draws."""
    from zkbench.reference.exp.exp import generate_indices

    with rng.scoped(Replay(draws)):
        return generate_indices(rounds, 80)[:rounds]


def the_round(wire: str) -> int:
    return int.from_bytes(hashlib.sha256(wire.encode()).digest()[:4], "big") % 80


@pytest.mark.parametrize("kind", sorted(set(traffic.TAMPER_KINDS) - {"exp_round"}))
def test_reference_rejects_each_tampering_kind(small_ring_proof, kind):
    """Whatever rounds the draws sample."""
    wire, job = small_ring_proof
    bad = traffic.tamper(wire, kind)
    assert bad != wire
    for k in range(2):
        assert not reference_verify(dict(job, wire=bad, draws=rng.DeterministicSource(b"draws %d" % k).random_bytes(8192)))


def test_reference_rejects_one_round_fault_where_sampled(small_ring_proof):
    wire, job = small_ring_proof
    bad = traffic.tamper(wire, "exp_round")
    assert bad != wire and len(json.loads(bad)["expProof"]) == 80
    r, seen = the_round(wire), set()
    for k in range(12):
        draws = rng.DeterministicSource(b"draws %d" % k).random_bytes(8192)
        hit = r in sampled(draws)
        assert reference_verify(dict(job, wire=bad, draws=draws)) is (not hit)
        assert reference_verify(dict(job, wire=wire, draws=draws)) is True
        if hit:  # a verifier that checks one round fewer lets it pass where it was the last one sampled
            last = sampled(draws).index(r) == 19
            assert reference_verify(dict(job, wire=bad, draws=draws, rounds=19)) is last
        seen.add(hit)
    assert seen == {True, False}


def test_slot_draws_are_the_port_verifiers_samples():
    """The port's verifier (plain versions, ring 16) on one batch of valid
    and one-round-fault proofs, its draws from a kept source: the
    reference, each slot replaying its cut of the draws, gives every
    verdict the port gave; cut one slot off, it does not."""
    import torch

    from zkbench.harness import cell
    from zkecdsa_tpu_torch.protocol.batch_verify import BatchVerifier
    from zkecdsa_tpu_torch.serde import read_json
    from zkecdsa_tpu_torch.utils import rng as port_rng
    from zkecdsa_tpu_torch.zkp_attest_list import SignatureProofList, SystemParametersList

    cfg = traffic.Config(name="t", ring=16, sec_level=80, verify_rounds=20, hardened_pedersen=0, hardened_gk=0)
    inst = traffic.make_instances(cfg, 3, seed=11)
    params = serde.read_json(zk.SystemParametersList, inst.params_json)
    valid = []
    for i in range(3):
        with rng.deterministic(b"tape %d" % i):
            proof = zk.prove_signature_list(params, inst.msg_hashes[i], inst.sigs[i], inst.pubs[i], inst.whichs[i],
                                            inst.ring)
        valid.append(serde.write_json(zk.SignatureProofList, proof))
    bad = [traffic.tamper(w, "exp_round") for w in valid]
    entries = [(0, valid[0]), (0, bad[0]), (1, bad[1]), (2, bad[2]), (1, valid[1]), (0, bad[0]), (1, bad[1]),
               (2, bad[2]), (2, bad[2])]
    cell.use_port_config(cfg)
    torch.set_num_threads(1)
    verifier = BatchVerifier(read_json(SystemParametersList, inst.params_json), torch.device("cpu"))
    prev = port_rng.get_source()
    log = cell.DrawLog(port_rng.DeterministicSource(b"port draws 3"))
    port_rng.set_source(log)
    try:
        got = verifier.verify([inst.msg_hashes[i] for i, _ in entries], inst.ring,
                              [read_json(SignatureProofList, w) for _, w in entries])
    finally:
        port_rng.set_source(prev)
    stream = log.take()
    cut = slot_draws(stream, len(entries), 80, 20)
    cfg_job = dataclasses.asdict(cfg)

    def ref(j, draws):
        i, w = entries[j]
        return reference_verify(dict(cfg=cfg_job, params_json=inst.params_json, msg_hash=inst.msg_hashes[i],
                                     ring=inst.ring, rounds=20, wire=w, draws=draws))

    want = [ref(j, cut[j]) for j in range(len(entries))]
    assert got == want
    assert {want[j] for j in (1, 2, 3, 5, 6, 7, 8)} == {True, False}  # the faults caught where sampled only
    shifted = [ref(j, cut[j + 1]) for j in range(len(entries) - 1)]
    assert shifted != want[:-1]


def test_the_verify_control_accepts_round_faults(small_ring_proof):
    """The verify control checks no exponent round: the round and
    point-addition faults pass it, the GK faults do not."""
    wire, job = small_ring_proof
    for kind in ("exp_response", "point_add"):
        assert reference_verify(dict(job, wire=traffic.tamper(wire, kind), rounds=0))
    for kind in ("gk_response", "gk_length"):
        assert not reference_verify(dict(job, wire=traffic.tamper(wire, kind), rounds=0))
