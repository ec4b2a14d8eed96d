"""Exponent (scalar-multiplication) sigma protocol - the heart of ZKAttest
(L3a, reference src/exp/exp.ts).

Cut-and-choose proof of
  ZK{(s, r, rx, ry) : s*R = P (+ Q)  and  Cs = s*R + r*S on P-256
                      and Cx, Cy commit P's coordinates on Tom-256}

The prover runs ``secparam`` independent rounds; one 80-bit Fiat-Shamir
challenge over all round commitments picks, per round, either
  * bit 1: reveal the round randomness (alpha, r, coordinate blindings), or
  * bit 0: reveal z = alpha - s plus a point-addition proof that
    T1 + P = T where T1 = z*R (+ Q).

The verifier spot-checks a random subset of ``secparam`` rounds
(exp.ts:233-349); the top-level API calls it with secparam=20 while the
prover ran 80 (zkpAttestList.ts:177).

All 80 rounds are embarrassingly parallel.
"""

from __future__ import annotations

from typing import Optional

from ..bignum import big
from ..commit.pedersen import Commitment, PedersenParams
from ..curves.group import Point, Scalar, hash_points
from ..curves.multimult import MultiMult, Relation
from .pointAdd import PointAddProof, aggregate_point_add, prove_point_add

__all__ = ["ExpProof", "prove_exp", "verify_exp", "padded_bits", "generate_indices"]


class ExpProof:
    """Per-round proof with two optional response shapes (exp.ts:26-84)."""

    __slots__ = ("A", "Tx", "Ty", "alpha", "beta1", "beta2", "beta3", "z", "z2", "proof", "r1", "r2")

    def __init__(
        self,
        A: Point,
        Tx: Point,
        Ty: Point,
        alpha: Optional[Scalar] = None,
        beta1: Optional[Scalar] = None,
        beta2: Optional[Scalar] = None,
        beta3: Optional[Scalar] = None,
        z: Optional[Scalar] = None,
        z2: Optional[Scalar] = None,
        proof: Optional[PointAddProof] = None,
        r1: Optional[Scalar] = None,
        r2: Optional[Scalar] = None,
    ) -> None:
        self.A = A
        self.Tx = Tx
        self.Ty = Ty
        self.alpha = alpha
        self.beta1 = beta1
        self.beta2 = beta2
        self.beta3 = beta3
        self.z = z
        self.z2 = z2
        self.proof = proof
        self.r1 = r1
        self.r2 = r2

    def eq(self, o: "ExpProof") -> bool:
        def opt(a, b):
            return a.eq(b) if (a is not None and b is not None) else False

        c0 = self.A.eq(o.A) and self.Tx.eq(o.Tx) and self.Ty.eq(o.Ty)
        r1shape = (
            opt(self.alpha, o.alpha)
            and opt(self.beta1, o.beta1)
            and opt(self.beta2, o.beta2)
            and opt(self.beta3, o.beta3)
        )
        r0shape = (
            opt(self.z, o.z)
            and opt(self.z2, o.z2)
            and opt(self.proof, o.proof)
            and opt(self.r1, o.r1)
            and opt(self.r2, o.r2)
        )
        return c0 and (r1shape or r0shape)


def padded_bits(val: int, length: int) -> list[bool]:
    """LSB-first challenge bits padded to `length` (exp.ts:87-94)."""
    return [bool((val >> i) & 1) for i in range(length)]


def generate_indices(indnum: int, limit: int) -> list[int]:
    """Knuth Algorithm-P shuffle of [0, limit); the verifier uses the first
    `indnum` entries.  The reference's trailing `.slice(indnum)` is a no-op
    (exp.ts:95-109) so the full permutation is returned - we reproduce that
    observable behavior (the caller takes indices[:secparam])."""
    ret = list(range(limit))
    for i in range(limit - 2):
        j = big.rnd_range(i, limit - 1)
        ret[i], ret[j] = ret[j], ret[i]
    return ret


def prove_exp(
    params_nist: PedersenParams,
    params_proof: PedersenParams,
    s: int,
    Cs: Commitment,
    P: Point,
    Px: Commitment,
    Py: Commitment,
    secparam: int,
    Q: Optional[Point] = None,
) -> list[ExpProof]:
    """(exp.ts:126-231).  params_nist.g must be the point R being raised."""
    order = params_nist.c.order
    alpha: list[Scalar] = []
    r: list[Scalar] = []
    T: list[Point] = []
    A: list[Point] = []
    Tx: list[Commitment] = []
    Ty: list[Commitment] = []
    for _ in range(secparam):
        a_i = params_nist.c.random_scalar()
        r_i = params_nist.c.random_scalar()
        T_i = params_nist.g.mul(a_i)
        A_i = T_i.add(params_nist.h.mul(r_i))
        coord = T_i.to_affine()
        if coord is None:
            raise ValueError("T[i] is at infinity")
        alpha.append(a_i)
        r.append(r_i)
        T.append(T_i)
        A.append(A_i)
        Tx.append(params_proof.commit(coord[0]))
        Ty.append(params_proof.commit(coord[1]))

    pts = [Px.p, Py.p]
    for i in range(secparam):
        pts += [A[i], Tx[i].p, Ty[i].p]
    challenge = hash_points(pts)

    proofs: list[ExpProof] = []
    for i in range(secparam):
        if challenge & 1:
            proofs.append(
                ExpProof(
                    A[i], Tx[i].p, Ty[i].p,
                    alpha=alpha[i], beta1=r[i], beta2=Tx[i].r, beta3=Ty[i].r,
                )
            )
        else:
            z = alpha[i].sub(params_nist.c.new_scalar(s))
            T1 = params_nist.g.mul(z)
            if Q is not None:
                T1 = T1.add(Q)
            coord = T1.to_affine()
            if coord is None:
                raise ValueError("T1 is at infinity")
            T1x = params_proof.commit(coord[0])
            T1y = params_proof.commit(coord[1])
            # alpha*R - s*R = z*R  =>  T1 + P = T
            pa = prove_point_add(
                params_proof, T1, P, T[i], T1x, T1y, Px, Py, Tx[i], Ty[i]
            )
            proofs.append(
                ExpProof(
                    A[i], Tx[i].p, Ty[i].p,
                    z=z, z2=r[i].sub(Cs.r), proof=pa, r1=T1x.r, r2=T1y.r,
                )
            )
        challenge >>= 1
    return proofs


def verify_exp(
    params_nist: PedersenParams,
    params_proof: PedersenParams,
    Clambda: Point,
    Px: Point,
    Py: Point,
    pi: list[ExpProof],
    secparam: int,
    Q: Optional[Point] = None,
) -> bool:
    """(exp.ts:233-349).  Spot-checks `secparam` random rounds; folds all
    checks into two MultiMults (one per curve) evaluated once."""
    if secparam > len(pi):
        raise ValueError("security level not achieved")
    multiW = MultiMult(params_proof.c)
    multiN = MultiMult(params_nist.c)
    multiW.add_known(params_proof.g)
    multiW.add_known(params_proof.h)
    multiN.add_known(params_nist.g)
    multiN.add_known(params_nist.h)
    multiN.add_known(Clambda)

    pts = [Px, Py]
    for p in pi:
        pts += [p.A, p.Tx, p.Ty]
    challenge = hash_points(pts)
    indices = generate_indices(secparam, len(pi))
    bits = padded_bits(challenge, len(pi))

    one_n = params_nist.c.new_scalar(1)
    one_w = params_proof.c.new_scalar(1)
    for j in range(secparam):
        i = indices[j]
        round_pi = pi[i]
        if bits[i]:
            if not (round_pi.alpha and round_pi.beta1 and round_pi.beta2 and round_pi.beta3):
                raise ValueError("params not found")
            T = params_nist.g.mul(round_pi.alpha)
            relA = Relation(params_nist.c)
            relA.insert_m(
                [T, params_nist.h, round_pi.A.neg()],
                [one_n, round_pi.beta1, one_n],
            )
            relA.drain(multiN)
            coord = T.to_affine()
            if coord is None:
                raise ValueError("T is at infinity")
            sx = params_proof.c.new_scalar(coord[0])
            sy = params_proof.c.new_scalar(coord[1])
            relTx = Relation(params_proof.c)
            relTx.insert_m(
                [params_proof.g, params_proof.h, round_pi.Tx.neg()],
                [sx, round_pi.beta2, one_w],
            )
            relTy = Relation(params_proof.c)
            relTy.insert_m(
                [params_proof.g, params_proof.h, round_pi.Ty.neg()],
                [sy, round_pi.beta3, one_w],
            )
            relTx.drain(multiW)
            relTy.drain(multiW)
        else:
            if not (round_pi.z and round_pi.z2 and round_pi.proof and round_pi.r1 and round_pi.r2):
                raise ValueError("params not found")
            T1 = params_nist.g.mul(round_pi.z)
            relA = Relation(params_nist.c)
            relA.insert_m(
                [T1, Clambda, round_pi.A.neg(), params_nist.h],
                [one_n, one_n, one_n, round_pi.z2],
            )
            relA.drain(multiN)
            if Q is not None:
                T1 = T1.add(Q)
            coord = T1.to_affine()
            if coord is None:
                raise ValueError("T1 is at infinity")
            sx = params_proof.c.new_scalar(coord[0])
            sy = params_proof.c.new_scalar(coord[1])
            T1x = params_proof.g.dblmul(sx, params_proof.h, round_pi.r1)
            T1y = params_proof.g.dblmul(sy, params_proof.h, round_pi.r2)
            if not aggregate_point_add(
                params_proof, T1x, T1y, Px, Py, round_pi.Tx, round_pi.Ty,
                round_pi.proof, multiW,
            ):
                return False
    return multiW.evaluate().is_identity() and multiN.evaluate().is_identity()
