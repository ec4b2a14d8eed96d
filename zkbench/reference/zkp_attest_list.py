"""Top-level ZKAttest API (layer L4, reference src/zkpAttestList.ts).

Proves knowledge of an ECDSA-P256 signature valid under one of a public
ring of keys, without revealing which (ZKAttest, Faz-Hernandez/Ladd/Maram,
SAC 2021).

Why it is zero-knowledge of the signature: the proof embeds R and proves
knowledge of s1 = s/r with s1*R = Q + PK, where Q = (z/r)*G is publicly
recomputable - the rearranged ECDSA verification equation - so (r, s) is
never revealed (zkpAttestList.ts:104-145).

Asymmetry (observable behavior we reproduce): the prover runs
``params.sec_level`` (default 80) exp rounds while the top-level verifier
spot-checks only 20 (hardcoded at zkpAttestList.ts:177).
"""

from __future__ import annotations

from .bignum import big
from .commit.pedersen import PedersenParams, generate_pedersen_params
from .curves.group import Point
from .curves.instances import p256, tomEdwards256
from .exp.exp import ExpProof, prove_exp, verify_exp
from .proofGK.gk import GKProof, prove_membership, verify_membership

__all__ = [
    "SignatureProofList",
    "SystemParametersList",
    "generate_params_list",
    "prove_signature_list",
    "verify_signature_list",
]


class SignatureProofList:
    """{R, comS1, keyXcom, keyYcom, expProof[], membershipProof}
    (zkpAttestList.ts:29-61)."""

    __slots__ = ("R", "comS1", "keyXcom", "keyYcom", "expProof", "membershipProof")

    def __init__(
        self,
        R: Point,
        comS1: Point,
        keyXcom: Point,
        keyYcom: Point,
        expProof: list[ExpProof],
        membershipProof: GKProof,
    ) -> None:
        self.R = R
        self.comS1 = comS1
        self.keyXcom = keyXcom
        self.keyYcom = keyYcom
        self.expProof = expProof
        self.membershipProof = membershipProof

    def eq(self, o: "SignatureProofList") -> bool:
        return (
            self.R.eq(o.R)
            and self.comS1.eq(o.comS1)
            and self.keyXcom.eq(o.keyXcom)
            and self.keyYcom.eq(o.keyYcom)
            and len(self.expProof) == len(o.expProof)
            and all(a.eq(b) for a, b in zip(self.expProof, o.expProof))
            and self.membershipProof.eq(o.membershipProof)
        )


class SystemParametersList:
    """Two Pedersen parameter sets + security level
    (zkpAttestList.ts:65-78)."""

    __slots__ = ("nist_group", "proof_group", "sec_level")

    def __init__(
        self, nist_group: PedersenParams, proof_group: PedersenParams, sec_level: int
    ) -> None:
        self.nist_group = nist_group
        self.proof_group = proof_group
        self.sec_level = sec_level

    def eq(self, o: "SystemParametersList") -> bool:
        return (
            self.nist_group.eq(o.nist_group)
            and self.proof_group.eq(o.proof_group)
            and self.sec_level == o.sec_level
        )


def _truncate_to_n(msg: int, n: int) -> int:
    """ECDSA hash truncation (zkpAttestList.ts:80-86)."""
    delta = big.bit_len(msg) - big.bit_len(n)
    return msg >> delta if delta > 0 else msg


def generate_params_list(sec_level: int | None = None) -> SystemParametersList:
    """(zkpAttestList.ts:88-92).  Params are random (h = r*g), so prover and
    verifier must share them via serde.  ``sec_level`` defaults to
    ``Config.sec_level`` (80, the reference's only knob; override via
    ZKECDSA_SEC_LEVEL)."""
    if sec_level is None:
        from .utils.config import get_config

        sec_level = get_config().sec_level
    return SystemParametersList(
        generate_pedersen_params(p256),
        generate_pedersen_params(tomEdwards256),
        sec_level,
    )


def prove_signature_list(
    params: SystemParametersList,
    msg_hash: bytes,
    sig_bytes: bytes,
    public_key_raw: bytes,
    which: int,
    keys: list[int],
) -> SignatureProofList:
    """(zkpAttestList.ts:104-145).  ``public_key_raw`` is the SEC1
    uncompressed key (our replacement for the WebCrypto CryptoKey export)."""
    ec = p256
    pk_point = ec.deserialize_point(public_key_raw)
    pk_coords = pk_point.to_affine()
    if pk_coords is None:
        raise ValueError("invalid public key")
    order = ec.order
    z = _truncate_to_n(big.from_bytes(msg_hash), order)
    half = len(sig_bytes) // 2
    r = big.from_bytes(sig_bytes[:half])
    s = big.from_bytes(sig_bytes[half:])

    # Recover R by running signature verification once.
    sinv = big.inv_mod(s, order)
    u1 = sinv * z % order
    u2 = sinv * r % order
    R = ec.generator().mul(ec.new_scalar(u1)).add(pk_point.mul(ec.new_scalar(u2)))

    # Rearranged verification equation: s1*R = Q + PK with s1 = s/r,
    # Q = (z/r)*G.
    rinv = big.inv_mod(r, order)
    s1 = rinv * s % order
    z1 = rinv * z % order
    Q = ec.generator().mul(ec.new_scalar(z1))

    params_sig_exp = PedersenParams(p256, R, params.nist_group.h)
    comS1 = params_sig_exp.commit(s1)
    pkX = params.proof_group.commit(pk_coords[0])
    pkY = params.proof_group.commit(pk_coords[1])

    sig_proof = prove_exp(
        params_sig_exp, params.proof_group, s1, comS1, pk_point, pkX, pkY,
        params.sec_level, Q,
    )
    membership_proof = prove_membership(params.proof_group, pkX, which, keys)

    return SignatureProofList(R, comS1.p, pkX.p, pkY.p, sig_proof, membership_proof)


def verify_signature_list(
    params: SystemParametersList,
    msg_hash: bytes,
    keys: list[int],
    proof: SignatureProofList,
) -> bool:
    """(zkpAttestList.ts:147-184).  Verifier spot-checks 20 exp rounds."""
    ec = p256
    order = ec.order
    z = _truncate_to_n(big.from_bytes(msg_hash), order)
    coordR = proof.R.to_affine()
    if coordR is None:
        raise ValueError("R is at infinity")
    rinv = big.inv_mod(coordR[0], order)
    params_sig_exp = PedersenParams(p256, proof.R, params.nist_group.h)
    z1 = rinv * z % order
    Q = ec.generator().mul(ec.new_scalar(z1))

    if not verify_membership(
        params.proof_group, proof.keyXcom, keys, proof.membershipProof
    ):
        return False
    return verify_exp(
        params_sig_exp,
        params.proof_group,
        proof.comS1,
        proof.keyXcom,
        proof.keyYcom,
        proof.expProof,
        20,
        Q,
    )
