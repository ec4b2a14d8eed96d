"""Equality-of-committed-value sigma protocol (layer L2).

ZK{(x, r1, r2) : C1 = x*G + r1*H  and  C2 = x*G + r2*H}
(reference src/commit/equality.ts:52-116).

Fiat-Shamir challenge: 80-bit hash of (C1, C2, A1, A2).  Verification is
expressed as two Relations drained into a shared MultiMult, so a batch of
equality checks costs one MSM.
"""

from __future__ import annotations

from ..bignum import big
from ..curves.group import Point, Scalar, hash_points
from ..curves.multimult import MultiMult, Relation
from .pedersen import Commitment, PedersenParams

__all__ = ["EqualityProof", "prove_equality", "verify_equality", "aggregate_equality"]


class EqualityProof:
    __slots__ = ("A_1", "A_2", "t_x", "t_r1", "t_r2")

    def __init__(
        self, A_1: Point, A_2: Point, t_x: Scalar, t_r1: Scalar, t_r2: Scalar
    ) -> None:
        self.A_1 = A_1
        self.A_2 = A_2
        self.t_x = t_x
        self.t_r1 = t_r1
        self.t_r2 = t_r2

    def eq(self, o: "EqualityProof") -> bool:
        return (
            self.A_1.eq(o.A_1)
            and self.A_2.eq(o.A_2)
            and self.t_x.eq(o.t_x)
            and self.t_r1.eq(o.t_r1)
            and self.t_r2.eq(o.t_r2)
        )


def prove_equality(
    params: PedersenParams, x: int, C1: Commitment, C2: Commitment
) -> EqualityProof:
    """Commit the same nonce k twice, respond t = k - c*x etc.
    (equality.ts:60-78)."""
    k = big.rnd(params.c.order)
    A1 = params.commit(k)
    A2 = params.commit(k)
    c = hash_points([C1.p, C2.p, A1.p, A2.p])
    cc = params.c.new_scalar(c)
    kk = params.c.new_scalar(k)
    xx = params.c.new_scalar(x)
    t_x = kk.sub(cc.mul(xx))
    t_r1 = A1.r.sub(cc.mul(C1.r))
    t_r2 = A2.r.sub(cc.mul(C2.r))
    return EqualityProof(A1.p, A2.p, t_x, t_r1, t_r2)


def verify_equality(
    params: PedersenParams, C1: Point, C2: Point, pi: EqualityProof
) -> bool:
    multi = MultiMult(params.c)
    if not aggregate_equality(params, C1, C2, pi, multi):
        return False
    return multi.evaluate().is_identity()


def aggregate_equality(
    params: PedersenParams, C1: Point, C2: Point, pi: EqualityProof, multi: MultiMult
) -> bool:
    """Two 4-term Relations: t_x*G + t_ri*H + c*Ci - Ai = 0
    (equality.ts:94-116)."""
    c = hash_points([C1, C2, pi.A_1, pi.A_2])
    cc = params.c.new_scalar(c)
    one = params.c.new_scalar(1)
    for Ci, Ai, t_r in ((C1, pi.A_1, pi.t_r1), (C2, pi.A_2, pi.t_r2)):
        rel = Relation(params.c)
        rel.insert_m(
            [params.g, params.h, Ci, Ai.neg()], [pi.t_x, t_r, cc, one]
        )
        rel.drain(multi)
    return True
