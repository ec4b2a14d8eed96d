"""Short-Weierstrass groups with complete projective formulas (layer L1).

Math follows Renes-Costello-Batina 2015 ("Complete addition formulas for
prime order elliptic curves", algorithms for a = -3), the same published
formulas the reference transcribes (reference src/curves/weier.ts:133-230).
We express them in factored form (cross products / complete-formula
intermediates) rather than a register-level straight line; the branchless
structure is what makes these formulas vectorize on the GPU path
(:mod:`zkecdsa_tpu_torch.ops.curve_ops` evaluates the identical algebra on
limb tensors).

Wire format (weier.ts:74-89, 244-255): SEC1 uncompressed ``0x04 || x || y``,
identity encodes as a single zero byte.
"""

from __future__ import annotations

from typing import Optional

from ..bignum import big
from .group import Group, Point

__all__ = ["WeierstrassGroup", "WeierstrassPoint"]


class WeierstrassGroup(Group):
    """y^2 z = x^3 + a x z^2 + b z^3 over F_p with a = -3 (weier.ts:25-95)."""

    def __init__(
        self,
        name: str,
        p: int,
        a: int,
        b: int,
        order: int,
        gen: tuple[int, int],
    ) -> None:
        super().__init__(name, p, order)
        for v in (a, b, gen[0], gen[1]):
            big.verify_pos_range(v, p)
        if a % p != p - 3:
            raise ValueError("only supports a=-3")
        self.a = a
        self.b = b
        self.gen = gen
        if not self.is_on_group(self.generator()):
            raise ValueError("generator not on group")

    def identity(self) -> "WeierstrassPoint":
        return WeierstrassPoint(self, 0, 1, 0)

    def generator(self) -> "WeierstrassPoint":
        return WeierstrassPoint(self, self.gen[0], self.gen[1], 1)

    def is_on_group(self, pt: "WeierstrassPoint") -> bool:
        """Projective curve equation check (weier.ts:56-70)."""
        p, a, b = self.p, self.a, self.b
        x, y, z = pt.x, pt.y, pt.z
        lhs = (y * y % p) * z
        rhs = x * x % p * x + a * x % p * (z * z % p) + b * (z * z % p) * z
        return self.eq(pt.group) and (lhs - rhs) % p == 0

    def size_point_bytes(self) -> int:
        return 1 + 2 * self.size_field_bytes()

    def deserialize_point(self, data: bytes) -> "WeierstrassPoint":
        if len(data) == 1 and data[0] == 0:
            return self.identity()
        if len(data) == self.size_point_bytes() and data[0] == 0x04:
            fb = self.size_field_bytes()
            x = big.from_bytes(data[1 : 1 + fb])
            y = big.from_bytes(data[1 + fb :])
            pt = WeierstrassPoint(self, x, y, 1)
            if not self.is_on_group(pt):
                raise ValueError("point not in group")
            return pt
        raise ValueError("error deserializing Point")


class WeierstrassPoint(Point):
    """Homogeneous projective point (X : Y : Z); identity is (0 : 1 : 0)."""

    __slots__ = ("group", "x", "y", "z")

    def __init__(self, group: WeierstrassGroup, x: int, y: int, z: int = 1) -> None:
        self.group = group
        self.x = x
        self.y = y
        self.z = z

    def __repr__(self) -> str:
        return f"WeierstrassPoint({self.group.name}, 0x{self.x:x}, 0x{self.y:x}, 0x{self.z:x})"

    def is_identity(self) -> bool:
        return self.x == 0 and self.y != 0 and self.z == 0

    def eq(self, pt: "WeierstrassPoint") -> bool:
        """Projective equality via cross-multiplication (weier.ts:120-128)."""
        p = self.group.p
        return (
            self.group.eq(pt.group)
            and (self.x * pt.z - pt.x * self.z) % p == 0
            and (self.y * pt.z - pt.y * self.z) % p == 0
        )

    def neg(self) -> "WeierstrassPoint":
        return WeierstrassPoint(self.group, self.x, (-self.y) % self.group.p, self.z)

    def dbl(self) -> "WeierstrassPoint":
        """Complete doubling, RCB15 exception-free formulas for a = -3
        (weier.ts:133-175)."""
        p, b = self.group.p, self.group.b
        x, y, z = self.x, self.y, self.z
        xx = x * x % p
        yy = y * y % p
        zz = z * z % p
        xy2 = 2 * x * y % p
        xz2 = 2 * x * z % p
        yz2 = 2 * y * z % p
        w = 3 * (b * zz - xz2) % p
        zc = (yy - w) % p
        xc = (yy + w) % p
        v = 3 * (b * xz2 % p - 3 * zz - xx) % p
        u = 3 * (xx - zz) % p
        x3 = (xy2 * zc - yz2 * v) % p
        y3 = (xc * zc + u * v) % p
        z3 = 4 * (yz2 * yy % p) % p
        return WeierstrassPoint(self.group, x3, y3, z3)

    def add(self, pt: "WeierstrassPoint") -> "WeierstrassPoint":
        """Complete addition, RCB15 exception-free formulas for a = -3
        (weier.ts:176-230).  Works for any inputs including identity and
        P + P, which is what lets the GPU path stay branchless."""
        self.is_compat_point(pt)
        p, b = self.group.p, self.group.b
        x1, y1, z1 = self.x, self.y, self.z
        x2, y2, z2 = pt.x, pt.y, pt.z
        m0 = x1 * x2 % p
        m1 = y1 * y2 % p
        m2 = z1 * z2 % p
        sxy = ((x1 + y1) * (x2 + y2) - m0 - m1) % p
        syz = ((y1 + z1) * (y2 + z2) - m1 - m2) % p
        sxz = ((x1 + z1) * (x2 + z2) - m0 - m2) % p
        w = 3 * (sxz - b * m2 % p) % p
        zc = (m1 - w) % p
        xc = (m1 + w) % p
        v = 3 * (b * sxz % p - 3 * m2 - m0) % p
        u = 3 * (m0 - m2) % p
        x3 = (sxy * xc - syz * v) % p
        y3 = (xc * zc + u * v) % p
        z3 = (syz * zc + sxy * u) % p
        return WeierstrassPoint(self.group, x3, y3, z3)

    def to_affine(self) -> Optional[tuple[int, int]]:
        if self.is_identity():
            return None
        p = self.group.p
        zinv = big.inv_mod(self.z, p)
        return (self.x * zinv % p, self.y * zinv % p)

    def to_bytes(self) -> bytes:
        coord = self.to_affine()
        if coord is None:
            return b"\x00"  # identity: single zero byte (weier.ts:75-76)
        fb = self.group.size_field_bytes()
        return b"\x04" + big.to_bytes(coord[0], fb) + big.to_bytes(coord[1], fb)
