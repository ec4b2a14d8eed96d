"""Host group abstraction (layer L1).

Mirrors the reference's capabilities (reference src/curves/group.ts): an
abstract prime-order ``Group`` with ``Point`` and ``Scalar`` types, generic
fixed-window scalar multiplication, Shamir double-mult, and the Fiat-Shamir
point hash (SHA-256 truncated to 80 bits, group.ts:221-233).

This is the scalar host path.  The batched GPU path in
:mod:`zkecdsa_tpu_torch.ops` operates on limb tensors and is tested against
these classes.
"""

from __future__ import annotations

import hashlib
from typing import Optional, Sequence

from ..bignum import big

__all__ = ["Group", "Point", "Scalar", "hash_points"]


class Scalar:
    """Element of Z_order. Always stored reduced (group.ts:159-218)."""

    __slots__ = ("group", "k")

    def __init__(self, group: "Group", k: int) -> None:
        self.group = group
        self.k = k % group.order

    def __repr__(self) -> str:
        return f"Scalar({self.group.name}, 0x{self.k:x})"

    def eq(self, other: "Scalar") -> bool:
        return self.group.eq(other.group) and self.k == other.k

    def add(self, s: "Scalar") -> "Scalar":
        return Scalar(self.group, self.k + s.k)

    def sub(self, s: "Scalar") -> "Scalar":
        return Scalar(self.group, self.k - s.k)

    def mul(self, s: "Scalar") -> "Scalar":
        return Scalar(self.group, self.k * s.k)

    def neg(self) -> "Scalar":
        return Scalar(self.group, -self.k)

    def inv(self) -> "Scalar":
        return Scalar(self.group, big.inv_mod(self.k, self.group.order))

    def is_one(self) -> bool:
        return self.k == 1

    def is_zero(self) -> bool:
        return self.k == 0

    def cmp(self, s: "Scalar") -> int:
        return (self.k > s.k) - (self.k < s.k)

    def to_bytes(self) -> bytes:
        return big.to_bytes(self.k, self.group.size_field_bytes())


class Point:
    """Abstract group element (group.ts:71-153)."""

    group: "Group"

    def is_identity(self) -> bool:
        raise NotImplementedError

    def eq(self, other: "Point") -> bool:
        raise NotImplementedError

    def neg(self) -> "Point":
        raise NotImplementedError

    def dbl(self) -> "Point":
        raise NotImplementedError

    def add(self, other: "Point") -> "Point":
        raise NotImplementedError

    def to_affine(self) -> Optional[tuple[int, int]]:
        """Affine (x, y) coordinates, or None for the point at infinity."""
        raise NotImplementedError

    def to_bytes(self) -> bytes:
        raise NotImplementedError

    def sub(self, other: "Point") -> "Point":
        return self.add(other.neg())

    def mul(self, s: Scalar) -> "Point":
        """Fixed 4-bit-window scalar multiplication (group.ts:133-152):
        16-entry table of small multiples, then 4 doublings + 1 add per
        nibble of the scalar, most-significant nibble first."""
        self.group.is_compat_scalar(s)
        table = self._window_table()
        q = self.group.identity()
        for nib in _nibbles(s.k):
            q = q.dbl().dbl().dbl().dbl()
            q = q.add(table[nib])
        return q

    def dblmul(self, s1: Scalar, p2: "Point", s2: Scalar) -> "Point":
        """Shamir's trick: s1*self + s2*p2 with shared doublings
        (group.ts:97-132)."""
        self.group.is_compat_scalar(s1)
        self.group.is_compat_scalar(s2)
        self.group.is_compat_point(p2)
        t1 = self._window_table()
        t2 = p2._window_table()
        n1, n2 = _nibbles(s1.k), _nibbles(s2.k)
        width = max(len(n1), len(n2))
        n1 = [0] * (width - len(n1)) + n1
        n2 = [0] * (width - len(n2)) + n2
        q = self.group.identity()
        for a, b in zip(n1, n2):
            q = q.dbl().dbl().dbl().dbl()
            q = q.add(t1[a])
            q = q.add(t2[b])
        return q

    def _window_table(self) -> list["Point"]:
        table = [self.group.identity()]
        for _ in range(15):
            table.append(table[-1].add(self))
        return table

    def is_compat_point(self, pt: "Point") -> bool:
        return self.group.is_compat_point(pt)

    def is_compat_scalar(self, s: Scalar) -> bool:
        return self.group.is_compat_scalar(s)


def _nibbles(k: int) -> list[int]:
    """Base-16 digits of k, most significant first (at least one digit),
    matching the reference's hex-string windowing (group.ts:141)."""
    return [int(c, 16) for c in format(k, "x")]


class Group:
    """Abstract prime-order group over F_p (group.ts:20-67)."""

    def __init__(self, name: str, p: int, order: int) -> None:
        self.name = name
        self.p = p
        self.order = order

    def __repr__(self) -> str:
        return f"Group({self.name})"

    # --- abstract ---
    def identity(self) -> Point:
        raise NotImplementedError

    def generator(self) -> Point:
        raise NotImplementedError

    def is_on_group(self, pt: Point) -> bool:
        raise NotImplementedError

    def size_point_bytes(self) -> int:
        raise NotImplementedError

    def deserialize_point(self, data: bytes) -> Point:
        raise NotImplementedError

    # --- concrete ---
    def eq(self, g: "Group") -> bool:
        return self.name == g.name

    def size_field_bytes(self) -> int:
        return (big.bit_len(self.p) + 7) // 8

    def new_scalar(self, k: int) -> Scalar:
        return Scalar(self, k)

    def random_scalar(self) -> Scalar:
        return self.new_scalar(big.rnd(self.order))

    def deserialize_scalar(self, data: bytes) -> Scalar:
        s = big.from_bytes(data)
        big.verify_pos_range(s, self.order)
        return self.new_scalar(s)

    def is_compat_point(self, pt: Point) -> bool:
        if not self.eq(pt.group):
            raise ValueError("points not compatible")
        return True

    def is_compat_scalar(self, s: Scalar) -> bool:
        if not self.eq(s.group):
            raise ValueError("scalar not compatible")
        return True


def hash_points(points: Sequence[Point]) -> int:
    """Fiat-Shamir challenge over point byte serializations: SHA-256 of the
    concatenation, truncated to the first 10 bytes = 80-bit integer
    (group.ts:221-233)."""
    data = b"".join(p.to_bytes() for p in points)
    return big.from_bytes(hashlib.sha256(data).digest()[:10])
