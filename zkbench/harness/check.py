"""How ``correct`` is decided: the plain reference (``zkbench.reference``)
works out again, from the same instances and tapes, the answers of a
sample of the window drawn from the seed, and each compared number is
held to its limit.

* prove: the wire JSON of sampled window proofs against the reference
  prover's on the same instance and tape (``proofs_differing``), and the
  proofs a batch failed to return (``proofs_missing``);
* verify: the window verdict at every tampered slot, and at every slot of
  sampled valid pool entries, against the reference verifier's on the
  same proof with the same draws (``verdicts_differing``), and the
  verdicts a batch failed to return (``verdicts_missing``).  The
  program's verifier draws its round sample from the port's own OS
  source; the run keeps those bytes (``cell.DrawLog``), and the reference
  replays each slot's share of them (:func:`slot_draws`), so it checks
  the rounds the program was to check.

Every limit is 0: the comparisons are exact.  The reference runs after the
window, in a few worker processes (``spawn``), each of which imports the
reference alone.
"""

from __future__ import annotations

import concurrent.futures
import hashlib
import multiprocessing
import os
import random

LIMITS = {"proofs_differing": 0, "proofs_missing": 0, "verdicts_differing": 0, "verdicts_missing": 0}


def _ref_config(cfg: dict) -> None:
    from zkbench.harness import traffic

    traffic.use_reference_config(traffic.Config(**cfg))


def reference_prove(job: dict) -> str:
    """The reference prover's wire JSON for one instance and tape.  With
    ``sec_level`` below the configuration's it is the prove control: the
    same proof with fewer exponent rounds."""
    from zkbench.reference import serde, zkp_attest_list as zk
    from zkbench.reference.utils import rng

    cfg = job["cfg"]
    _ref_config(cfg)
    params = serde.read_json(zk.SystemParametersList, job["params_json"])
    if job.get("sec_level") is not None:
        params = zk.SystemParametersList(params.nist_group, params.proof_group, job["sec_level"])
    with rng.deterministic(job["tape"]):
        proof = zk.prove_signature_list(
            params, job["msg_hash"], job["sig"], job["pub"], job["which"], job["ring"],
        )
    return serde.write_json(zk.SignatureProofList, proof)


class Exhausted(RuntimeError):
    """A replay asked for more bytes than were drawn."""


class Replay:
    """A random source that hands out ``data`` again, in order.  With
    ``only``, just the draws of ``only`` bytes come from ``data``, and
    every other draw, and any past the end, from the OS; else a draw past
    the end raises :class:`Exhausted`."""

    def __init__(self, data: bytes, only: int | None = None) -> None:
        self.data, self.pos, self.only = data, 0, only

    def random_bytes(self, n: int) -> bytes:
        if self.only is not None and (n != self.only or self.pos + n > len(self.data)):
            return os.urandom(n)
        if self.pos + n > len(self.data):
            raise Exhausted(f"{n} bytes asked at {self.pos} of {len(self.data)}")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out


def slot_draws(stream: bytes, slots: int, rounds_a_proof: int, sampled: int) -> list[bytes]:
    """Each slot's share of one verify call's draws (``stream``, the bytes
    the program's verifier drew, in order): the verifier draws one
    shuffle of a proof's rounds a slot, slot by slot, before any other
    draw, so the reference's own shuffle, replayed, cuts the stream.  That
    holds for a call of at most ``BatchVerifier.MAX_CHUNK`` proofs (one
    chunk), each with its ``R`` and all its rounds, as every pool entry."""
    from zkbench.reference.exp.exp import generate_indices
    from zkbench.reference.utils import rng

    src, out = Replay(stream), []
    with rng.scoped(src):
        for _ in range(slots):
            start = src.pos
            try:
                generate_indices(sampled, rounds_a_proof)
            except Exhausted:
                out.append(stream[start:])
                break
            out.append(stream[start:src.pos])
    return out


def reference_verify(job: dict) -> bool:
    """The reference verifier's verdict on one proof's wire JSON, checking
    ``rounds`` exponent rounds (the configuration's ``verify_rounds``; the
    verify controls fewer) of the shuffle that ``draws`` replays: its
    draws of one byte, a round index each, as the port's are.  Its other
    draws, the 32-byte weights of its batched checks, which decide
    nothing, are the OS's.  A proof the reference cannot parse or that
    makes it raise is rejected."""
    from zkbench.reference import serde, zkp_attest_list as zk
    from zkbench.reference.bignum import big
    from zkbench.reference.commit.pedersen import PedersenParams
    from zkbench.reference.curves.instances import p256
    from zkbench.reference.exp.exp import verify_exp
    from zkbench.reference.proofGK.gk import verify_membership
    from zkbench.reference.utils import rng

    cfg = job["cfg"]
    _ref_config(cfg)
    params = serde.read_json(zk.SystemParametersList, job["params_json"])
    try:
        proof = serde.read_json(zk.SignatureProofList, job["wire"])
    except (ValueError, KeyError, TypeError):
        return False
    order = p256.order
    with rng.scoped(Replay(job["draws"], only=1)):
        try:
            z = zk._truncate_to_n(big.from_bytes(job["msg_hash"]), order)
            coord = proof.R.to_affine()
            if coord is None:
                return False
            z1 = big.inv_mod(coord[0], order) * z % order
            Q = p256.generator().mul(p256.new_scalar(z1))
            if not verify_membership(params.proof_group, proof.keyXcom, job["ring"], proof.membershipProof):
                return False
            return bool(verify_exp(
                PedersenParams(p256, proof.R, params.nist_group.h), params.proof_group, proof.comS1,
                proof.keyXcom, proof.keyYcom, proof.expProof, job["rounds"], Q,
            ))
        except (ValueError, IndexError, AttributeError, TypeError):
            return False


def run_jobs(fn, jobs: list[dict], workers: int | None = None) -> list:
    """``fn`` over ``jobs`` in worker processes (``spawn``), in order;
    every worker has ended when this returns."""
    if not jobs:
        return []
    if workers is None:
        workers = max(1, min(len(jobs), 4, (os.cpu_count() or 2) // 2))
    if workers == 1:
        return [fn(j) for j in jobs]
    with concurrent.futures.ProcessPoolExecutor(
        max_workers=workers, mp_context=multiprocessing.get_context("spawn"),
    ) as pool:
        return list(pool.map(fn, jobs))


def draw(seed: int, what: str, items: list, k: int) -> list:
    rs = random.Random(hashlib.sha256(repr((int(seed), what)).encode()).digest())
    return rs.sample(items, min(k, len(items)))


def judge_prove(seed: int, kept: list[tuple], k: int, make_job, missing: int):
    """``kept``: (batch, slot, program wire, job fields) of the candidate
    window proofs; ``k`` of them, drawn from the seed, are worked out
    again by the reference prover.  Returns the compared numbers and the sample."""
    sample = draw(seed, "prove sample", list(range(len(kept))), k)
    jobs = [make_job(kept[i]) for i in sample]
    ref = run_jobs(reference_prove, jobs)
    differing = sum(1 for i, w in zip(sample, ref) if kept[i][2] != w)
    return {"proofs_differing": differing, "proofs_missing": missing}, len(sample)


def verify_compared(seed: int, slots: list, kind_of, k: int) -> list[int]:
    """The window slots whose verdicts are compared (``slots``: (batch,
    slot, pool entry) each; ``kind_of``: entry -> its kind, "valid" for a
    valid proof): every tampered one, and every one of ``k`` valid pool
    entries drawn from the seed."""
    valid = sorted({e for _, _, e in slots if kind_of(e) == "valid"})
    picked = set(draw(seed, "verify sample valid", valid, k))
    return [i for i, (_, _, e) in enumerate(slots) if kind_of(e) != "valid" or e in picked]


def reference_verdicts(seed: int, slots: list, kind_of, k: int, make_job) -> tuple[list[int], list]:
    """The compared slots, and the reference's verdict at each
    (``make_job(i)``: the reference's job for slot ``i``, its draws among
    them)."""
    compared = verify_compared(seed, slots, kind_of, k)
    return compared, run_jobs(reference_verify, [make_job(i) for i in compared])


def judge_verify(seed: int, slots: list, verdicts: list, kind_of, k: int, make_job, missing: int,
                 ref: tuple | None = None):
    """``slots``, ``verdicts``: the window's (batch, slot, entry) and its
    verdict, in order.  The compared slots' reference verdicts (``ref``,
    or worked out here) against the window's."""
    compared, answers = ref if ref is not None else reference_verdicts(seed, slots, kind_of, k, make_job)
    differing = sum(1 for i, r in zip(compared, answers) if verdicts[i] != r)
    return {"verdicts_differing": differing, "verdicts_missing": missing}, len(compared)


def checks_line(numbers: dict) -> dict:
    """Each compared number beside its limit, for the result's last key."""
    return {name: {"value": v, "limit": LIMITS[name]} for name, v in numbers.items()}


def passed(numbers: dict) -> bool:
    return all(v <= LIMITS[name] for name, v in numbers.items())
