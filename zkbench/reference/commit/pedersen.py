"""Pedersen commitments (layer L2, reference src/commit/pedersen.ts).

A commitment to v with blinding r is C = r*H + v*G; the ``Commitment``
wrapper carries (point, blinding) and is homomorphic under add/sub/scalar
mul, which the point-addition proof exploits to recombine committed
coordinates (pointAdd.ts:137-161).
"""

from __future__ import annotations

from ..bignum import big
from ..curves.group import Group, Point, Scalar

__all__ = [
    "Commitment",
    "PedersenParams",
    "generate_pedersen_params",
    "hash_to_point",
]


class Commitment:
    """(point, blinding scalar) pair with homomorphic ops
    (pedersen.ts:21-36)."""

    __slots__ = ("p", "r")

    def __init__(self, p: Point, r: Scalar) -> None:
        self.p = p
        self.r = r

    def add(self, c: "Commitment") -> "Commitment":
        return Commitment(self.p.add(c.p), self.r.add(c.r))

    def sub(self, c: "Commitment") -> "Commitment":
        return Commitment(self.p.sub(c.p), self.r.sub(c.r))

    def mul(self, k: int) -> "Commitment":
        sk = self.p.group.new_scalar(k)
        return Commitment(self.p.mul(sk), self.r.mul(sk))


class PedersenParams:
    """Commitment bases (g, h) over group c (pedersen.ts:40-59)."""

    __slots__ = ("c", "g", "h")

    def __init__(self, c: Group, g: Point, h: Point) -> None:
        self.c = c
        self.g = g
        self.h = h

    def eq(self, o: "PedersenParams") -> bool:
        return self.c.eq(o.c) and self.g.eq(o.g) and self.h.eq(o.h)

    def commit(self, value: int) -> Commitment:
        """C = r*h + v*g with fresh random blinding r (pedersen.ts:53-58).
        Evaluated with Shamir double-mult."""
        r = self.c.random_scalar()
        v = self.c.new_scalar(value)
        return Commitment(self.h.dblmul(r, self.g, v), r)

    def commit_with_blinding(self, value: int, r: Scalar) -> Commitment:
        """Deterministic commit used by the batched prover after drawing the
        random tape up front."""
        v = self.c.new_scalar(value)
        return Commitment(self.h.dblmul(r, self.g, v), r)


def generate_pedersen_params(c: Group, g: Point | None = None) -> PedersenParams:
    """Default: h = r*g for random r, matching the reference's (flagged)
    setup (pedersen.ts:61-69; its own comment notes h should be derived
    without a known dlog).  With ``Config.hardened_pedersen`` set, h comes
    from deterministic try-and-increment hash-to-curve instead (SURVEY
    section 7.5 hardened mode): nobody knows log_g(h), and the derivation
    is publicly recomputable from g.  Wire format is unchanged either way
    (params serialize as two points)."""
    from ..utils.config import get_config

    if g is None:
        g = c.generator()
    if get_config().hardened_pedersen:
        return PedersenParams(c, g, hash_to_point(c, g.to_bytes()))
    r = c.random_scalar()
    return PedersenParams(c, g, g.mul(r))


def hash_to_point(c: Group, seed: bytes) -> Point:
    """Deterministic try-and-increment hash-to-curve into the prime-order
    subgroup of ``c``.

    x candidates come from SHA-256("zkecdsa-h2c" || group name || seed ||
    counter); the curve equation is solved for y (both supported moduli
    are 3 mod 4, so sqrt is one exponentiation), the even y root is taken
    for determinism, the cofactor is cleared by multiplying by 8 (covers
    twisted Edwards cofactors 4 and 8; a no-op shift within the subgroup
    for the cofactor-1 Weierstrass instances), and membership is checked
    exactly (non-identity and order * P == identity) before returning.
    NOT constant-time - setup-only, like the reference's generator
    (pedersen.ts:61-69)."""
    import hashlib

    from ..curves.edwards import TEdwards, TEdwardsPoint
    from ..curves.weier import WeierstrassGroup, WeierstrassPoint

    p = c.p
    assert p % 4 == 3, "hash_to_point assumes p = 3 (mod 4)"
    order = c.order
    for ctr in range(1 << 16):
        d = hashlib.sha256(
            b"zkecdsa-h2c" + c.name.encode() + seed + ctr.to_bytes(4, "big")
        ).digest()
        x = big.from_bytes(d) % p
        if isinstance(c, WeierstrassGroup):
            rhs = (pow(x, 3, p) + c.a * x + c.b) % p
        elif isinstance(c, TEdwards):
            # a x^2 + y^2 = 1 + d x^2 y^2  ->  y^2 = (1 - a x^2)/(1 - d x^2)
            den = (1 - c.d * x * x) % p
            if den == 0:
                continue
            rhs = (1 - c.a * x * x) % p * big.inv_mod(den, p) % p
        else:  # pragma: no cover - no other group kinds exist
            raise TypeError(f"unsupported group {c!r}")
        if rhs != 0 and not big.is_square(rhs, p):
            continue
        y = pow(rhs, (p + 1) >> 2, p)
        if y * y % p != rhs:
            continue
        if y % 2 == 1:
            y = p - y
        pt = (
            WeierstrassPoint(c, x, y, 1)
            if isinstance(c, WeierstrassGroup)
            else TEdwardsPoint(c, x, y)
        )
        if not c.is_on_group(pt):
            continue
        pt = pt.dbl().dbl().dbl()  # clear cofactor (mult by 8)
        if pt.is_identity():
            continue
        if not pt.mul(c.new_scalar(order - 1)).add(pt).is_identity():
            continue  # not in the prime-order subgroup
        return pt
    raise RuntimeError("hash_to_point: no valid point found")
