"""Twisted Edwards groups in extended coordinates (layer L1).

Math follows Hisil-Wong-Carter-Dawson 2008, "Twisted Edwards Curves
Revisited": unified addition (S3.1) and doubling (S3.3) in extended
coordinates (X : Y : T : Z) with T = XY/Z - the same published formulas the
reference uses (reference src/curves/edwards.ts:141-183).  Branchless and
complete for our prime-order subgroup usage, hence directly vectorizable on
the GPU path (:mod:`zkecdsa_tpu_torch.ops.curve_ops`).

Wire format (edwards.ts:66-86, 194-203): ``0x04 || x || y`` with
field-size (33-byte for Tom-256) big-endian coordinates.
"""

from __future__ import annotations

from typing import Optional

from ..bignum import big
from .group import Group, Point

__all__ = ["TEdwards", "TEdwardsPoint"]


class TEdwards(Group):
    """a x^2 + y^2 = 1 + d x^2 y^2 over F_p (edwards.ts:25-93)."""

    def __init__(
        self,
        name: str,
        p: int,
        a: int,
        d: int,
        order: int,
        gen: tuple[int, int],
    ) -> None:
        super().__init__(name, p, order)
        for v in (a, d, gen[0], gen[1]):
            big.verify_pos_range(v, p)
        self.a = a
        self.d = d
        self.gen = gen
        if not self.is_on_group(self.generator()):
            raise ValueError("generator not on group")

    def identity(self) -> "TEdwardsPoint":
        return TEdwardsPoint(self, 0, 1, 0, 1)

    def generator(self) -> "TEdwardsPoint":
        gx, gy = self.gen
        return TEdwardsPoint(self, gx, gy, gx * gy % self.p, 1)

    def is_on_group(self, pt: "TEdwardsPoint") -> bool:
        """Dual-equation projective check: a X^2 + Y^2 = Z^2 + d T^2 and
        X Y = Z T (edwards.ts:52-65)."""
        p, a, d = self.p, self.a, self.d
        x, y, t, z = pt.x, pt.y, pt.t, pt.z
        eq1 = (a * (x * x % p) + y * y - z * z - d * (t * t % p)) % p == 0
        eq2 = (x * y - z * t) % p == 0
        return self.eq(pt.group) and eq1 and eq2

    def size_point_bytes(self) -> int:
        return 1 + 2 * self.size_field_bytes()

    def deserialize_point(self, data: bytes) -> "TEdwardsPoint":
        if len(data) == self.size_point_bytes() and data[0] == 0x04:
            fb = self.size_field_bytes()
            x = big.from_bytes(data[1 : 1 + fb])
            y = big.from_bytes(data[1 + fb :])
            big.verify_pos_range(x, self.p)
            big.verify_pos_range(y, self.p)
            pt = TEdwardsPoint(self, x, y, x * y % self.p, 1)
            if not self.is_on_group(pt):
                raise ValueError(f"point not on TEdwards group: {self.name}")
            return pt
        raise ValueError("error deserializing TEdwardsPoint")


class TEdwardsPoint(Point):
    """Extended-coordinate point (X : Y : T : Z); identity is (0:1:0:1)."""

    __slots__ = ("group", "x", "y", "_t", "z")

    def __init__(
        self, group: TEdwards, x: int, y: int, t: Optional[int] = None, z: int = 1
    ) -> None:
        self.group = group
        self.x = x
        self.y = y
        self._t = t  # lazy: see the ``t`` property
        self.z = z

    @property
    def t(self) -> int:
        """Extended coordinate T = X*Y/Z, computed on first use: the
        batched prover constructs ~34 proof points per even round whose T
        is never touched (serde writes affine x/y only) - eagerly paying
        a 256-bit multiply each was a measurable assembly-stage slice."""
        if self._t is None:
            self._t = self.x * self.y % self.group.p
        return self._t

    @t.setter
    def t(self, value: int) -> None:
        self._t = value

    def __repr__(self) -> str:
        return f"TEdwardsPoint({self.group.name}, 0x{self.x:x}, 0x{self.y:x})"

    def is_identity(self) -> bool:
        return (
            self.x == 0
            and self.y != 0
            and self.t == 0
            and self.z != 0
            and self.y == self.z
        )

    def eq(self, pt: "TEdwardsPoint") -> bool:
        p = self.group.p
        return (
            self.group.eq(pt.group)
            and (self.x * pt.z - pt.x * self.z) % p == 0
            and (self.y * pt.z - pt.y * self.z) % p == 0
        )

    def neg(self) -> "TEdwardsPoint":
        p = self.group.p
        return TEdwardsPoint(self.group, (-self.x) % p, self.y, (-self.t) % p, self.z)

    def dbl(self) -> "TEdwardsPoint":
        """HWCD08 S3.3 doubling (edwards.ts:141-160)."""
        p, a = self.group.p, self.group.a
        x, y, z = self.x, self.y, self.z
        A = x * x % p
        B = y * y % p
        C = 2 * (z * z % p) % p
        D = a * A % p
        E = ((x + y) * (x + y) - A - B) % p
        G = (D + B) % p
        F = (G - C) % p
        H = (D - B) % p
        return TEdwardsPoint(self.group, E * F % p, G * H % p, E * H % p, F * G % p)

    def add(self, pt: "TEdwardsPoint") -> "TEdwardsPoint":
        """HWCD08 S3.1 unified addition (edwards.ts:161-183)."""
        self.is_compat_point(pt)
        p, a, d = self.group.p, self.group.a, self.group.d
        x1, y1, t1, z1 = self.x, self.y, self.t, self.z
        x2, y2, t2, z2 = pt.x, pt.y, pt.t, pt.z
        A = x1 * x2 % p
        B = y1 * y2 % p
        C = d * t1 % p * t2 % p
        D = z1 * z2 % p
        E = ((x1 + y1) * (x2 + y2) - A - B) % p
        F = (D - C) % p
        G = (D + C) % p
        H = (B - a * A) % p
        return TEdwardsPoint(self.group, E * F % p, G * H % p, E * H % p, F * G % p)

    def to_affine(self) -> Optional[tuple[int, int]]:
        p = self.group.p
        zinv = big.inv_mod(self.z, p)
        return (self.x * zinv % p, self.y * zinv % p)

    def to_bytes(self) -> bytes:
        x, y = self.to_affine()
        fb = self.group.size_field_bytes()
        return b"\x04" + big.to_bytes(x, fb) + big.to_bytes(y, fb)
