"""The one general traffic generator: everything a cell feeds the program,
made from ``--seed`` and the parameters of a traffic file
(``zkbench/traffic/<name>.json``) and a configuration file
(``zkbench/configs/<name>.json``).

The inputs are made with the plain reference's host arithmetic
(``zkbench.reference``), never with the program, and handed to both
sides: the system parameters (as wire JSON), the signers' keys, messages
and ECDSA signatures, the ring and each prover tape's seed.

A traffic file's keys:

* ``path``: ``prove`` or ``verify``, the entry point its batches drive.
* ``batch``: proofs a batch; ``pool``: instances (prove) or proofs
  (verify) made in set-up, from which the batches are drawn.
* ``tamper_every``, ``tamper_kinds``, ``tampered``: verify mixes only.
  About one slot in ``tamper_every`` holds a tampered proof, the same
  number in every run; ``tampered`` tampered proofs are made in set-up,
  their kinds cycling through ``tamper_kinds`` (see :data:`TAMPER_KINDS`).
* ``check``: how many answers of a run the reference works out again
  (prove: proofs; verify: valid pool entries, each at every slot the
  window sent it to, beside every tampered slot).
* ``trace_batches``: batches under the profiler in a ``--trace 1`` run.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import random
from pathlib import Path

from zkbench.reference import ecdsa as ref_ecdsa
from zkbench.reference import serde as ref_serde
from zkbench.reference import zkp_attest_list as ref_zk
from zkbench.reference.bignum import big as ref_big
from zkbench.reference.curves.instances import p256 as ref_p256
from zkbench.reference.curves.weier import WeierstrassPoint
from zkbench.reference.utils import config as ref_config
from zkbench.reference.utils import rng as ref_rng

# Each kind swaps two valid values inside one proof's wire JSON, so the
# proof still parses and every layer of the verifier meets well-formed
# input.  What rejects it:
TAMPER_KINDS = {
    # round 0's commitment A swapped with round 1's: the Fiat-Shamir
    # challenge changes, sampled rounds lack the fields their new bit
    # needs (verify.host_prep)
    "exp_commit": "verify.host_prep",
    # every round's responses swapped (alpha <-> beta1, z <-> z2): the
    # P-256 identity row fails (verify.device, msm.*)
    "exp_response": "msm P-256",
    # one round's responses swapped, the round drawn from the proof's
    # bytes: rejected only by a verifier whose sample holds that round
    # (20 of 80: one time in four), so a verifier that checks fewer
    # rounds, or others, than its draws name gives other verdicts
    "exp_round": "msm P-256 or Tom-256, where the round is sampled",
    # every point-add proof's first product proof: t_x <-> t_y; the
    # Tom-256 identity row fails
    "point_add": "msm Tom-256",
    # the GK responses f[0] <-> f[1]: the ring recombination gives another
    # total, the Tom-256 identity row fails (verify.gk_recombine, msm.*)
    "gk_response": "verify.gk_recombine, msm Tom-256",
    # one GK bit commitment dropped: the length check rejects
    # (verify.gk_recombine)
    "gk_length": "verify.gk_recombine",
}

P256_P = ref_p256.p
P256_N = ref_p256.order


@dataclasses.dataclass(frozen=True)
class Mix:
    name: str
    path: str
    batch: int
    pool: int
    check: int
    trace_batches: int
    tamper_every: int = 0
    tamper_kinds: tuple = ()
    tampered: int = 0

    @classmethod
    def load(cls, path: Path) -> "Mix":
        with open(path) as fh:
            raw = json.load(fh)
        fields = {f.name for f in dataclasses.fields(cls)}
        unknown = set(raw) - fields - {"why"}
        if unknown:
            raise ValueError(f"{path}: unknown keys {sorted(unknown)}")
        raw = {k: v for k, v in raw.items() if k in fields}
        raw["tamper_kinds"] = tuple(raw.get("tamper_kinds", ()))
        mix = cls(name=path.stem, **{k: v for k, v in raw.items() if k != "name"})
        if mix.path not in ("prove", "verify"):
            raise ValueError(f"{path}: path must be prove or verify, not {mix.path!r}")
        bad = [k for k in mix.tamper_kinds if k not in TAMPER_KINDS]
        if bad:
            raise ValueError(f"{path}: unknown tamper kinds {bad}")
        return mix


@dataclasses.dataclass(frozen=True)
class Config:
    """A configuration file's protocol settings (the rest of the file is
    its provenance)."""

    name: str
    ring: int
    sec_level: int
    verify_rounds: int
    hardened_pedersen: int
    hardened_gk: int

    @classmethod
    def load(cls, path: Path) -> "Config":
        with open(path) as fh:
            raw = json.load(fh)
        return cls(**{f.name: raw[f.name] for f in dataclasses.fields(cls)})


def sub_seed(seed: int, *parts) -> bytes:
    """32 bytes for one purpose, from the run's seed (any size of int)."""
    return hashlib.sha256(repr((int(seed),) + parts).encode()).digest()


def use_reference_config(cfg: Config) -> None:
    """The reference's module configuration for ``cfg``."""
    ref_config.set_config(ref_config.Config(
        sec_level=cfg.sec_level, verify_rounds=cfg.verify_rounds,
        hardened_pedersen=cfg.hardened_pedersen, hardened_gk=cfg.hardened_gk,
    ))


class _GTable:
    """Multiples v * 256^j * G of the P-256 generator (32 windows of 8
    bits), so a scalar multiple of G takes 31 additions: keys and
    signatures for a pool of hundreds are made in a fraction of a second
    instead of seconds."""

    def __init__(self) -> None:
        rows, base = [], ref_p256.generator()
        for _ in range(32):
            row = [ref_p256.identity(), base]
            for _ in range(254):
                row.append(row[-1].add(base))
            rows.append(row)
            base = row[-1].add(base)  # 256 * base
        self.rows = rows

    def mul(self, k: int) -> WeierstrassPoint:
        acc = None
        for j in range(32):
            d = (k >> (8 * j)) & 0xFF
            if d:
                acc = self.rows[j][d] if acc is None else acc.add(self.rows[j][d])
        return acc if acc is not None else ref_p256.identity()


@dataclasses.dataclass
class Instances:
    """Signed instances over one ring, and the parameters as wire JSON."""

    params_json: str
    msg_hashes: list[bytes]
    sigs: list[bytes]
    pubs: list[bytes]
    whichs: list[int]
    ring: list[int]


def make_instances(cfg: Config, count: int, seed: int) -> Instances:
    """``count`` signers with distinct keys at seeded ring slots, a message
    and an ECDSA-SHA256 signature each; the rest of the ring seeded values
    below the P-256 prime (the GK values are Tom-256 scalars)."""
    use_reference_config(cfg)
    with ref_rng.deterministic(sub_seed(seed, "params")):
        params = ref_zk.generate_params_list(cfg.sec_level)
    params_json = ref_serde.write_json(ref_zk.SystemParametersList, params)
    table = _GTable()
    msg_hashes, sigs, pubs = [], [], []
    with ref_rng.deterministic(sub_seed(seed, "signers")):
        for i in range(count):
            d = ref_big.rnd(P256_N - 1) + 1
            x, y = table.mul(d).to_affine()
            pubs.append(ref_ecdsa.export_public_raw(ref_ecdsa.KeyPair(d, WeierstrassPoint(ref_p256, x, y, 1))))
            msg = b"zkbench message " + sub_seed(seed, "message", i).hex().encode()
            digest = hashlib.sha256(msg).digest()
            z = ref_ecdsa._truncate_hash(digest)
            while True:
                k = ref_big.rnd(P256_N - 1) + 1
                r = table.mul(k).to_affine()[0] % P256_N
                s = ref_big.inv_mod(k, P256_N) * ((z + r * d) % P256_N) % P256_N
                if r and s:
                    break
            sigs.append(ref_big.to_bytes(r, 32) + ref_big.to_bytes(s, 32))
            msg_hashes.append(digest)
    if count > cfg.ring:
        raise ValueError(f"{count} signers do not fit a ring of {cfg.ring}")
    slot_rng = random.Random(sub_seed(seed, "ring"))
    whichs = slot_rng.sample(range(cfg.ring), count)
    ring = [slot_rng.getrandbits(256) % P256_P for _ in range(cfg.ring)]
    for i, slot in enumerate(whichs):
        ring[slot] = ref_ecdsa.key_to_int(pubs[i])
    return Instances(params_json, msg_hashes, sigs, pubs, whichs, ring)


def prove_batch(mix: Mix, seed: int, b: int) -> tuple[list[int], list[bytes]]:
    """Batch ``b`` of a prove mix: ``mix.batch`` distinct pool instances
    drawn by seed, and a fresh tape seed for each slot."""
    idx = random.Random(sub_seed(seed, "prove batch", b)).sample(range(mix.pool), mix.batch)
    return idx, [sub_seed(seed, "tape", b, j) for j in range(mix.batch)]


def pool_tape(seed: int, i: int) -> bytes:
    """The tape seed of verify-pool proof ``i``."""
    return sub_seed(seed, "pool tape", i)


def tampered_plan(mix: Mix, seed: int) -> list[tuple[int, str]]:
    """(pool proof, kind) of each tampered proof made in set-up."""
    if not mix.tampered:
        return []
    src = random.Random(sub_seed(seed, "tampered"))
    picks = src.sample(range(mix.pool), mix.tampered)
    return [(i, mix.tamper_kinds[k % len(mix.tamper_kinds)]) for k, i in enumerate(picks)]


def verify_batch(mix: Mix, seed: int, b: int) -> list[tuple[str, int]]:
    """Batch ``b`` of a verify mix: ``("valid", i)`` or ``("tampered", t)``
    a slot.  Valid slots are distinct pool proofs drawn by seed; batch b
    holds floor((b+1) B / E) - floor(b B / E) tampered slots (E =
    ``tamper_every``), so every run of a mix makes the same number, at
    seeded slots, from the tampered proofs in turn."""
    src = random.Random(sub_seed(seed, "verify batch", b))
    slots: list[tuple[str, int]] = [("valid", i) for i in src.sample(range(mix.pool), mix.batch)]
    if mix.tamper_every and mix.tampered:
        E, B = mix.tamper_every, mix.batch
        n_bad = (b + 1) * B // E - b * B // E
        first = b * B // E
        for k, pos in enumerate(src.sample(range(B), n_bad)):
            slots[pos] = ("tampered", (first + k) % mix.tampered)
    return slots


def tamper(wire: str, kind: str) -> str:
    """The wire JSON of a proof with one fault of ``kind`` (see
    :data:`TAMPER_KINDS`)."""
    d = json.loads(wire)
    rounds = d["expProof"]
    if kind == "exp_commit":
        rounds[0]["A"], rounds[1]["A"] = rounds[1]["A"], rounds[0]["A"]
    elif kind == "exp_response":
        for r in rounds:
            for a, b in (("alpha", "beta1"), ("z", "z2")):
                if a in r and b in r:
                    r[a], r[b] = r[b], r[a]
    elif kind == "exp_round":
        r = rounds[int.from_bytes(hashlib.sha256(wire.encode()).digest()[:4], "big") % len(rounds)]
        for a, b in (("alpha", "beta1"), ("z", "z2")):
            if a in r and b in r:
                r[a], r[b] = r[b], r[a]
    elif kind == "point_add":
        for r in rounds:
            if "proof" in r:
                pi = r["proof"]["pi_8"]
                pi["t_x"], pi["t_y"] = pi["t_y"], pi["t_x"]
    elif kind == "gk_response":
        f = d["membershipProof"]["f"]
        f[0], f[1] = f[1], f[0]
    elif kind == "gk_length":
        d["membershipProof"]["cl"].pop()
    else:
        raise KeyError(f"unknown tamper kind {kind!r}")
    return json.dumps(d, separators=(",", ":"))
