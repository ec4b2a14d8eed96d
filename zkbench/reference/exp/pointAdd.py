"""Point-addition sigma protocol over committed affine coordinates (L3a).

ZK{(P, Q, R) : R = P + Q}, with the six coordinates committed in the proof
group (Tom-256) (reference src/exp/pointAdd.ts).

The chord rule with lambda = (y2-y1)/(x2-x1):
    x3 = lambda^2 - x1 - x2,    y3 = lambda*(x1 - x3) - y1
is decomposed into four product proofs over intermediates
    i7 = x2-x1, i8 = i7^-1, i9 = y2-y1, i10 = lambda, i11 = lambda^2,
    i12 = x1-x3, i13 = lambda*i12
plus two equality proofs tying x3 and y3 to homomorphically recombined
commitments (pointAdd.ts:92-163).  Requires P, Q, R != infinity and P != Q.
"""

from __future__ import annotations

from ..bignum import big
from ..commit.equality import EqualityProof, aggregate_equality, prove_equality
from ..commit.mult import MultProof, aggregate_mult, prove_mult
from ..commit.pedersen import Commitment, PedersenParams
from ..curves.group import Point
from ..curves.multimult import MultiMult

__all__ = ["PointAddProof", "prove_point_add", "verify_point_add", "aggregate_point_add"]

_FIELDS = ("C_8", "C_10", "C_11", "C_13", "pi_8", "pi_10", "pi_11", "pi_13", "pi_x", "pi_y")


class PointAddProof:
    __slots__ = _FIELDS

    def __init__(self, *args) -> None:
        for name, value in zip(_FIELDS, args):
            setattr(self, name, value)

    def eq(self, o: "PointAddProof") -> bool:
        return all(getattr(self, f).eq(getattr(o, f)) for f in _FIELDS)


def prove_point_add(
    params: PedersenParams,
    P: Point,
    Q: Point,
    R: Point,
    PX: Commitment,
    PY: Commitment,
    QX: Commitment,
    QY: Commitment,
    RX: Commitment,
    RY: Commitment,
) -> PointAddProof:
    """(pointAdd.ts:92-163)."""
    if not P.add(Q).eq(R):
        raise ValueError("Points don't add up!")
    prime = params.c.order  # proof-group order == base-field prime of P-256
    for pt, nm in ((P, "P"), (Q, "Q"), (R, "R")):
        if pt.is_identity():
            raise ValueError(f"{nm} is at infinity")
    x1, y1 = P.to_affine()
    x2, y2 = Q.to_affine()
    x3, _y3 = R.to_affine()

    i7 = (x2 - x1) % prime
    i8 = big.inv_mod(i7, prime)
    i9 = (y2 - y1) % prime
    i10 = i8 * i9 % prime  # lambda
    i11 = i10 * i10 % prime  # lambda^2
    i12 = (x1 - x3) % prime
    i13 = i10 * i12 % prime

    C7 = QX.sub(PX)
    C8 = params.commit(i8)
    C9 = QY.sub(PY)
    C10 = params.commit(i10)
    C11 = params.commit(i11)
    C12 = PX.sub(RX)
    C13 = params.commit(i13)
    # Commitment to 1 with zero blinding: the base point g itself.
    C14 = Commitment(params.g, params.c.new_scalar(0))

    pi8 = prove_mult(params, i7, i8, 1, C7, C8, C14)
    pi10 = prove_mult(params, i8, i9, i10, C8, C9, C10)
    pi11 = prove_mult(params, i10, i10, i11, C10, C10, C11)
    # x3 = lambda^2 - x1 - x2  <=>  C11 opens like C3 + C1 + C2
    c_int = Commitment(RX.p.add(PX.p).add(QX.p), RX.r.add(PX.r).add(QX.r))
    pix = prove_equality(params, i11, C11, c_int)
    pi13 = prove_mult(params, i10, i12, i13, C10, C12, C13)
    # y3 = i13 - y1  <=>  C13 opens like C6 + C4
    c_int = Commitment(RY.p.add(PY.p), RY.r.add(PY.r))
    piy = prove_equality(params, i13, C13, c_int)

    return PointAddProof(C8.p, C10.p, C11.p, C13.p, pi8, pi10, pi11, pi13, pix, piy)


def verify_point_add(
    params: PedersenParams,
    PX: Point,
    PY: Point,
    QX: Point,
    QY: Point,
    RX: Point,
    RY: Point,
    pi: PointAddProof,
) -> bool:
    multi = MultiMult(params.c)
    if not aggregate_point_add(params, PX, PY, QX, QY, RX, RY, pi, multi):
        return False
    return multi.evaluate().is_identity()


def aggregate_point_add(
    params: PedersenParams,
    PX: Point,
    PY: Point,
    QX: Point,
    QY: Point,
    RX: Point,
    RY: Point,
    pi: PointAddProof,
    multi: MultiMult,
) -> bool:
    """Recompute C7, C9, C12 homomorphically; aggregate the six sub-proofs
    (pointAdd.ts:199-259)."""
    C7 = QX.sub(PX)
    C9 = QY.sub(PY)
    C12 = PX.sub(RX)
    C14 = params.g
    if not aggregate_mult(params, C7, pi.C_8, C14, pi.pi_8, multi):
        return False
    if not aggregate_mult(params, pi.C_8, C9, pi.C_10, pi.pi_10, multi):
        return False
    if not aggregate_mult(params, pi.C_10, pi.C_10, pi.C_11, pi.pi_11, multi):
        return False
    if not aggregate_equality(params, pi.C_11, RX.add(PX).add(QX), pi.pi_x, multi):
        return False
    if not aggregate_mult(params, pi.C_10, C12, pi.C_13, pi.pi_13, multi):
        return False
    if not aggregate_equality(params, pi.C_13, PY.add(RY), pi.pi_y, multi):
        return False
    return True
