"""Product sigma protocol (layer L2).

ZK{(x, y, z, rx, ry, rz) : z = x*y and Cx, Cy, Cz commit to x, y, z}
(reference src/commit/mult.ts:89-175).

The auxiliary commitment C4 = x*Cy is a commitment to z with blinding
r4 = x*ry; the protocol then proves consistent openings of the five nonce
commitments under one 80-bit challenge over 9 points.  Verification is five
Relations drained into the shared MultiMult.
"""

from __future__ import annotations

from ..bignum import big
from ..curves.group import Point, Scalar, hash_points
from ..curves.multimult import MultiMult, Relation
from .pedersen import Commitment, PedersenParams

__all__ = ["MultProof", "prove_mult", "verify_mult", "aggregate_mult"]

_FIELDS = (
    "C_4",
    "A_x",
    "A_y",
    "A_z",
    "A_4_1",
    "A_4_2",
    "t_x",
    "t_y",
    "t_z",
    "t_rx",
    "t_ry",
    "t_rz",
    "t_r4",
)


class MultProof:
    """13-field proof: 6 points + 7 response scalars (mult.ts:26-87)."""

    __slots__ = _FIELDS

    def __init__(self, *args) -> None:
        for name, value in zip(_FIELDS, args):
            setattr(self, name, value)

    def eq(self, o: "MultProof") -> bool:
        return all(getattr(self, f).eq(getattr(o, f)) for f in _FIELDS)


def prove_mult(
    params: PedersenParams,
    x: int,
    y: int,
    z: int,
    Cx: Commitment,
    Cy: Commitment,
    Cz: Commitment,
) -> MultProof:
    """(mult.ts:93-131)."""
    xx = params.c.new_scalar(x)
    C4_p = Cy.p.mul(xx)  # commitment to z under blinding r4 = x*ry
    r4 = Cy.r.mul(xx)
    k_x = big.rnd(params.c.order)
    k_y = big.rnd(params.c.order)
    k_z = big.rnd(params.c.order)
    kx = params.c.new_scalar(k_x)
    Ax = params.commit(k_x)
    Ay = params.commit(k_y)
    Az = params.commit(k_z)
    A4_1 = params.commit(k_z)
    A4_2 = Cy.p.mul(kx)
    c = hash_points([Cx.p, Cy.p, Cz.p, C4_p, Ax.p, Ay.p, Az.p, A4_1.p, A4_2])
    cc = params.c.new_scalar(c)
    ky = params.c.new_scalar(k_y)
    kz = params.c.new_scalar(k_z)
    yy = params.c.new_scalar(y)
    zz = params.c.new_scalar(z)
    return MultProof(
        C4_p,
        Ax.p,
        Ay.p,
        Az.p,
        A4_1.p,
        A4_2,
        kx.sub(cc.mul(xx)),
        ky.sub(cc.mul(yy)),
        kz.sub(cc.mul(zz)),
        Ax.r.sub(cc.mul(Cx.r)),
        Ay.r.sub(cc.mul(Cy.r)),
        Az.r.sub(cc.mul(Cz.r)),
        A4_1.r.sub(cc.mul(r4)),
    )


def verify_mult(
    params: PedersenParams, Cx: Point, Cy: Point, Cz: Point, pi: MultProof
) -> bool:
    multi = MultiMult(params.c)
    if not aggregate_mult(params, Cx, Cy, Cz, pi, multi):
        return False
    return multi.evaluate().is_identity()


def aggregate_mult(
    params: PedersenParams,
    Cx: Point,
    Cy: Point,
    Cz: Point,
    pi: MultProof,
    multi: MultiMult,
) -> bool:
    """Five Relations (mult.ts:148-175)."""
    c = hash_points(
        [Cx, Cy, Cz, pi.C_4, pi.A_x, pi.A_y, pi.A_z, pi.A_4_1, pi.A_4_2]
    )
    cc = params.c.new_scalar(c)
    one = params.c.new_scalar(1)
    g, h = params.g, params.h
    for pts, scalars in (
        ([g, h, Cx, pi.A_x.neg()], [pi.t_x, pi.t_rx, cc, one]),
        ([g, h, Cy, pi.A_y.neg()], [pi.t_y, pi.t_ry, cc, one]),
        ([g, h, Cz, pi.A_z.neg()], [pi.t_z, pi.t_rz, cc, one]),
        ([g, h, pi.C_4, pi.A_4_1.neg()], [pi.t_z, pi.t_r4, cc, one]),
        ([Cy, pi.C_4, pi.A_4_2.neg()], [pi.t_x, cc, one]),
    ):
        rel = Relation(params.c)
        rel.insert_m(pts, scalars)
        rel.drain(multi)
    return True
