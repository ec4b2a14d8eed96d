"""Batched elliptic-curve operations on limb tensors: the port's
counterpart of ``zkecdsa_tpu/ops/curve_ops.py``.

A batch of points is a canonical ``int32`` tensor ``[..., C, 9]`` (C = 3
projective coordinates for the Weierstrass curves, 4 extended coordinates
for Tom-256; see ops/field.py).  The formulas are the reference package's,
operation for operation: RCB15 complete addition for a = -3 and HWCD08
unified addition in extended coordinates, plus the mixed add against
affine comb-table rows.  So the plain versions here, the kernels in
``csrc/`` and the reference package reach the same canonical projective
coordinates wherever they take the same sequence of point operations.

Plain versions (``CurveOps`` methods) run on any device in plain PyTorch;
inside a method the coordinates stay in the field's redundant working form
and are canonicalised once at the end.  The kernel wrappers
(:func:`ec_add`, :func:`tree_sum`, :func:`window_table`, :func:`to_affine`,
:func:`chord`, :func:`straus_msm`, :func:`comb_mixed`, the prover's P-256 kernels
:func:`shamir`, :func:`comb4_bases`, :func:`comb4_entries`,
:func:`mul_comb4`, :func:`comb_weier`, :func:`msm`, :func:`msm_ladder`,
and the parameter set-up's :func:`comb8_bases`, :func:`comb8_entries`)
take the plain version for a CPU tensor and launch their kernel for any
other, or raise.
The bucket MSM's kernels are in ``ops/msm_bucket.py``.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import numpy as np
import torch

from .. import _build
from .field import NLIMBS, P256_P, TOM_N, TOM_P, WAR_P, FieldT, _check_limbs

__all__ = [
    "CurveOps",
    "WeierOps",
    "EdwardsOps",
    "p256_ops",
    "tom_ops",
    "war_ops",
    "nibble_digits",
    "byte_digits",
    "scalar_bits",
    "ec_add",
    "to_affine",
    "chord",
    "chord_plain",
    "CHORD_IN",
    "CHORD_OUT",
    "affine_plan",
    "affine_threads",
    "AffinePlan",
    "straus_msm",
    "straus_plan",
    "straus_teams",
    "comb_mixed",
    "comb_plan",
    "comb_resident",
    "CombPlan",
    "MixedComb",
    "WeierComb",
    "sum_reduce",
    "tree_sum",
    "window_table",
    "shamir",
    "comb4_table",
    "comb4_bases",
    "comb4_entries",
    "mul_comb4",
    "comb_weier",
    "comb8_bases",
    "comb8_entries",
    "comb_table",
    "comb_table_mixed",
    "msm",
    "msm_ladder",
]

WINDOW = 4
NDIGITS_256 = 64  # 256-bit scalars, 4-bit windows
TABLE = 1 << WINDOW
COMB_WINDOWS = 32  # 8-bit windows of a 256-bit scalar (fixed-base comb)
COMB_ENTRIES = 256  # multiples 0..255 a window


def nibble_digits(scalars, width: int = NDIGITS_256) -> np.ndarray:
    """Base-16 digits, most significant first: [N, width] int32.
    Vectorized via a big-endian byte view (width must be even)."""
    nbytes = width // 2
    buf = b"".join(int(s).to_bytes(nbytes, "big") for s in scalars)
    by = np.frombuffer(buf, dtype=np.uint8).reshape(len(scalars), nbytes)
    out = np.empty((len(scalars), width), dtype=np.int32)
    out[:, 0::2] = by >> 4
    out[:, 1::2] = by & 0xF
    return out


def scalar_bits(scalars, width: int = 256) -> np.ndarray:
    """Bits, most significant first: [N, width] uint8 (for msm_ladder)."""
    buf = b"".join(int(s).to_bytes(width // 8, "big") for s in scalars)
    by = np.frombuffer(buf, dtype=np.uint8).reshape(len(scalars), width // 8)
    return np.unpackbits(by, axis=1)


def byte_digits(scalars, width: int = 32) -> np.ndarray:
    """Base-256 digits, LEAST significant first: [N, width] int32 (the comb
    fixed-base path's digit order)."""
    buf = b"".join(int(s).to_bytes(width, "little") for s in scalars)
    by = np.frombuffer(buf, dtype=np.uint8).reshape(len(scalars), width)
    return by.astype(np.int32)


class CurveOps:
    """Shared machinery; subclasses provide the group law in the field's
    working form (``_wadd``/``_wdbl`` on [..., C, W] int64 digits)."""

    NCOORD: int = 3
    curve_id: int = -1  # csrc/curve.cuh ZK_CURVE_*

    def __init__(self, field: FieldT, group) -> None:
        self.f = field
        self.group = group  # host group for unpack

    # -- subclass interface -------------------------------------------------
    def _wadd(self, P: torch.Tensor, Q: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def _wdbl(self, P: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def identity_ints(self) -> list[int]:
        raise NotImplementedError

    def _host_coords(self, pt) -> list[int]:
        raise NotImplementedError

    def _host_point(self, coords: list[int]):
        raise NotImplementedError

    # -- representation ----------------------------------------------------
    def identity(self, batch_shape: tuple = (), device=None) -> torch.Tensor:
        ident = self.f.pack(self.identity_ints(), device)
        return ident.expand(tuple(batch_shape) + ident.shape)

    def _work(self, P: torch.Tensor) -> torch.Tensor:
        return self.f.to_work(P)

    def _canon(self, Pw: torch.Tensor) -> torch.Tensor:
        return self.f.canon(Pw)

    def _const(self, v: int, device) -> torch.Tensor:
        return self.f.to_work(self.f.const(v, device))

    def pack_points(self, pts, device=None) -> torch.Tensor:
        """Host curve points -> [N, C, 9] canonical limbs."""
        cols = list(zip(*(self._host_coords(pt) for pt in pts))) if pts else [[]] * self.NCOORD
        t = torch.stack([self.f.pack(c) for c in cols], dim=1) if pts else torch.zeros(
            (0, self.NCOORD, NLIMBS), dtype=torch.int32
        )
        return t.to(device or "cpu")

    def unpack_points(self, arr: torch.Tensor) -> list:
        """[..., C, 9] canonical limbs -> host points."""
        a = arr.reshape(-1, self.NCOORD, NLIMBS)
        cols = [self.f.unpack(a[:, k]) for k in range(self.NCOORD)]
        return [self._host_point(list(c)) for c in zip(*cols)]

    # -- plain versions on canonical limbs -----------------------------------
    def add(self, P: torch.Tensor, Q: torch.Tensor) -> torch.Tensor:
        return self._canon(self._wadd(self._work(P), self._work(Q)))

    def dbl(self, P: torch.Tensor) -> torch.Tensor:
        return self._canon(self._wdbl(self._work(P)))

    def select(self, mask: torch.Tensor, P: torch.Tensor, Q: torch.Tensor) -> torch.Tensor:
        """mask ? P : Q, mask shaped like the batch."""
        return torch.where(mask[..., None, None], P, Q)

    def to_affine(self, P: torch.Tensor):
        """(x, y, is_infinity) canonical; infinity yields (0, 0).  One
        batch inversion over all the points (``FieldT.wbatch_inv``, as the
        reference's ``batch_inv``)."""
        f = self.f
        z = P[..., -1, :]
        zinv = f.wbatch_inv(f.to_work(z).reshape(-1, f.W)).reshape(z.shape[:-1] + (f.W,))
        x = f.canon(f.wmul(f.to_work(P[..., 0, :]), zinv))
        y = f.canon(f.wmul(f.to_work(P[..., 1, :]), zinv))
        return x, y, f.is_zero(z)

    def _wtable(self, Pw: torch.Tensor) -> torch.Tensor:
        """[..., 16, C, W] window table of small multiples 0..15, built as
        the reference builds it (entry k = entry k-1 + P from the
        identity), so the projective coordinates match."""
        ident = self._work(self.identity(Pw.shape[:-2], Pw.device))
        out = [ident]
        for _ in range(TABLE - 1):
            out.append(self._wadd(out[-1], Pw))
        return torch.stack(out, dim=-3)

    def table(self, P: torch.Tensor) -> torch.Tensor:
        return self._canon(self._wtable(self._work(P)))

    def _gather_w(self, tabw: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
        """tabw [..., E, C, W] (batch dims broadcast against d [...]), int64
        entry indices d -> [..., C, W]."""
        batch = torch.broadcast_shapes(tabw.shape[:-3], d.shape)
        idx = d.expand(batch)[..., None, None, None].expand(batch + (1,) + tabw.shape[-2:])
        return tabw.expand(batch + tabw.shape[-3:]).gather(-3, idx).squeeze(-3)

    def double_mul_tables(
        self, tp: torch.Tensor, dP: torch.Tensor, tq: torch.Tensor, dQ: torch.Tensor
    ) -> torch.Tensor:
        """dP*P + dQ*Q from window tables [..., 16, C, 9] and MSB-first
        nibbles [..., 64] (batch dims broadcast): per digit column four
        doublings, then + tp[dP] and + tq[dQ] (the reference's Shamir scan,
        group.ts:97-132)."""
        batch = torch.broadcast_shapes(tp.shape[:-3], tq.shape[:-3], dP.shape[:-1], dQ.shape[:-1])
        tpw, tqw = self._work(tp), self._work(tq)
        dP, dQ = dP.to(torch.int64), dQ.to(torch.int64)
        acc = self._work(self.identity(batch, tp.device))
        for col in range(dP.shape[-1]):
            for _ in range(4):
                acc = self._wdbl(acc)
            acc = self._wadd(acc, self._gather_w(tpw, dP[..., col]))
            acc = self._wadd(acc, self._gather_w(tqw, dQ[..., col]))
        return self._canon(acc)

    def comb4_table(self, P: torch.Tensor) -> torch.Tensor:
        """Per-base 4-bit comb table [..., 64, 16, C, 9]: entry [j][d] =
        d * 16^(63-j) * P (position axis MSB-first, as nibble digits are),
        built as the reference builds it: 63 runs of four doublings give
        the position bases, then each doubling of the entry set adds
        m_k = dbl(entry k/2) to entries 0..k-1."""
        return self.comb4_entries(self.comb4_bases(P))

    def _wbases(self, Pw: torch.Tensor, n: int, wbits: int) -> list[torch.Tensor]:
        """The n window bases of a comb, LSB-first: entry k = 2^(wbits k)
        * P, from n - 1 runs of ``wbits`` doublings (working form)."""
        bases = [Pw]
        for _ in range(n - 1):
            b = bases[-1]
            for _ in range(wbits):
                b = self._wdbl(b)
            bases.append(b)
        return bases

    def _wentries(self, bw: torch.Tensor, n: int) -> torch.Tensor:
        """The multiples 0..n-1 of each base [..., C, W] -> [..., n, C, W]
        by index-set doubling, the reference's order: from (identity,
        base), each round adds m_k = dbl(entry k/2) to entries 0..k-1."""
        ident = self._work(self.identity(bw.shape[:-2], bw.device))
        tab = torch.stack([ident, bw], dim=-3)
        while tab.shape[-3] < n:
            k = tab.shape[-3]
            mk = self._wdbl(tab[..., k // 2, :, :])
            tab = torch.cat([tab, self._wadd(tab, mk[..., None, :, :])], dim=-3)
        return tab

    def comb4_bases(self, P: torch.Tensor) -> torch.Tensor:
        """The position bases of :meth:`comb4_table`, [..., 64, C, 9]:
        entry j = 16^(63-j) * P, from 63 runs of four doublings."""
        bases = self._wbases(self._work(P), NDIGITS_256, WINDOW)
        return self._canon(torch.stack(bases[::-1], dim=-3))

    def comb4_entries(self, bases: torch.Tensor) -> torch.Tensor:
        """The 16 entries of each position of :meth:`comb4_table` from its
        position bases [..., 64, C, 9] -> [..., 64, 16, C, 9]."""
        return self._canon(self._wentries(self._work(bases), TABLE))

    # -- the fixed-base comb tables of the Pedersen bases (reference
    #    curve_ops.py:307 comb_table, :666 comb_table_mixed): built once
    #    per parameter set, T[j][d] = d * 2^(8j) * base, then affine ------

    def comb8_bases(self, P: torch.Tensor) -> torch.Tensor:
        """The window bases of a comb table, [..., C, 9] -> [..., 32, C,
        9], LSB-first: entry j = 2^(8j) * P, from 31 runs of eight
        doublings."""
        return self._canon(torch.stack(self._wbases(self._work(P), COMB_WINDOWS, 8), dim=-3))

    def _comb8_affine(self, bases: torch.Tensor):
        """The 256 multiples of each window base [..., 32, C, 9] as affine
        working digits (x, y) [..., 32, 256, W] and the identity mask
        [..., 32, 256]: the entries by index-set doubling, then one batch
        inversion of every Z (the reference's ``to_affine``); the
        identity gives (0, 0)."""
        f = self.f
        tab = self._wentries(self._work(bases), COMB_ENTRIES)
        z = tab[..., -1, :]
        inf = f.is_zero(f.canon(z))
        zinv = f.wbatch_inv(z.reshape(-1, z.shape[-1])).reshape(z.shape)
        return f.wmul(tab[..., 0, :], zinv), f.wmul(tab[..., 1, :], zinv), inf

    def mul_comb4(self, tab: torch.Tensor, digits: torch.Tensor) -> torch.Tensor:
        """Multiply from a :meth:`comb4_table`: tab [..., 64, 16, C, 9],
        MSB-first nibbles [..., B, 64] -> [..., B, C, 9]; 64 gather-adds per
        scalar in position order, no doublings."""
        tw = self._work(tab)[..., None, :, :, :, :]  # [..., 1, 64, 16, C, W]
        d = digits.to(torch.int64)
        batch = torch.broadcast_shapes(tab.shape[:-4] + (1,), d.shape[:-1])
        acc = self._work(self.identity(batch, tab.device))
        for j in range(NDIGITS_256):
            acc = self._wadd(acc, self._gather_w(tw[..., j, :, :, :], d[..., j]))
        return self._canon(acc)

    def mul_comb(self, comb: torch.Tensor, d8: torch.Tensor) -> torch.Tensor:
        """Fixed-base multiply from a comb table [D, 256, C, 9] (entry
        [j][d] = d * 2^(8j) * base) and LSB-first byte digits [..., D] ->
        [..., C, 9]: one complete add per window, in window order."""
        d = d8.to(torch.int64)
        acc = self._work(self.identity(d.shape[:-1], comb.device))
        for j in range(comb.shape[0]):
            acc = self._wadd(acc, self._work(comb[j][d[..., j]]))
        return self._canon(acc)

    def sum_reduce(self, P: torch.Tensor, axis: int = 0) -> torch.Tensor:
        """Tree sum of points along an axis (the reference's
        ``sum_reduce``): exactly n-1 adds, an odd level carrying its last
        point up; the identity for an empty axis."""
        P = P.movedim(axis, 0)
        if P.shape[0] == 0:
            return self.identity(P.shape[1:-2], P.device).contiguous()
        return self._canon(self._wsum(self._work(P), 0))

    def _wsum(self, Pw: torch.Tensor, axis: int) -> torch.Tensor:
        """Tree sum with exactly n-1 adds; an odd width carries its last
        element to the next level (the reference's ``sum_reduce``)."""
        Pw = Pw.movedim(axis, 0)
        while Pw.shape[0] > 1:
            h = Pw.shape[0] // 2
            Pw = torch.cat([self._wadd(Pw[:h], Pw[h : 2 * h]), Pw[2 * h :]], dim=0)
        return Pw[0]

    def msm(self, points: torch.Tensor, digits: torch.Tensor) -> torch.Tensor:
        """sum_t s_t * P_t, the reference's ``msm`` schedule: points [..., T,
        C, 9], MSB-first nibbles [..., T, 64] -> [..., C, 9].  Each term is
        multiplied on its own window table (per digit column four
        doublings and one table add), then the T products are tree-summed."""
        if points.shape[-3] == 0:
            return self.identity(points.shape[:-3], points.device).contiguous()
        tabs = self._wtable(self._work(points))  # [..., T, 16, C, W]
        d = digits.to(torch.int64)
        acc = self._work(self.identity(d.shape[:-1], points.device))
        for col in range(d.shape[-1]):
            for _ in range(4):
                acc = self._wdbl(acc)
            acc = self._wadd(acc, self._gather_w(tabs, d[..., col]))
        return self._canon(self._wsum(acc, axis=-3))

    def msm_ladder(self, points: torch.Tensor, bits: torch.Tensor) -> torch.Tensor:
        """sum_t s_t * P_t without window tables, the reference's
        ``msm_ladder``: per term 256 MSB-first steps of a doubling, a
        complete add and a select on the bit, then a tree sum over the
        terms.  points [..., T, C, 9], bits [..., T, 256] -> [..., C, 9]."""
        if points.shape[-3] == 0:
            return self.identity(points.shape[:-3], points.device).contiguous()
        Pw = self._work(points)
        acc = self._work(self.identity(points.shape[:-2], points.device))
        b = bits.to(torch.bool)
        for k in range(b.shape[-1]):
            acc = self._wdbl(acc)
            acc = torch.where(b[..., k, None, None], self._wadd(acc, Pw), acc)
        return self._canon(self._wsum(acc, axis=-3))

    def msm_shared(self, points: torch.Tensor, digits: torch.Tensor) -> torch.Tensor:
        """Straus MSM, the reference's schedule: sum_t s_t * P_t with
        points [..., T, C, 9] and MSB-first 4-bit digits [..., T, D] ->
        [..., C, 9].  Per digit column the accumulator is doubled 4x and
        the T gathered window multiples are tree-summed into it."""
        tabs = self._wtable(self._work(points))  # [..., T, 16, C, W]
        W = tabs.shape[-1]
        batch = tabs.shape[:-4]
        acc = self._work(self.identity(batch, points.device))
        d = digits.to(torch.int64)
        for col in range(d.shape[-1]):
            for _ in range(4):
                acc = self._wdbl(acc)
            idx = d[..., col][..., None, None, None].expand(
                d.shape[:-1] + (1, self.NCOORD, W)
            )
            terms = tabs.gather(-3, idx).squeeze(-3)  # [..., T, C, W]
            if terms.shape[-3] == 0:
                continue
            acc = self._wadd(acc, self._wsum(terms, axis=-3))
        return self._canon(acc)


class WeierOps(CurveOps):
    """Short Weierstrass, a = -3, homogeneous projective (X:Y:Z); identity
    (0:1:0).  RCB15 complete formulas (reference ``WeierOps``)."""

    NCOORD = 3

    def __init__(self, field: FieldT, b: int, group, curve_id: int) -> None:
        super().__init__(field, group)
        self.b = b
        self.curve_id = curve_id

    def identity_ints(self) -> list[int]:
        return [0, 1, 0]

    def _host_coords(self, pt) -> list[int]:
        return [pt.x, pt.y, pt.z]

    def _host_point(self, c):
        from ..curves.weier import WeierstrassPoint

        return WeierstrassPoint(self.group, *c)

    def _wadd(self, P, Q):
        f = self.f
        b = self._const(self.b, P.device)
        x1, y1, z1 = P.unbind(-2)
        x2, y2, z2 = Q.unbind(-2)
        m0 = f.wmul(x1, x2)
        m1 = f.wmul(y1, y2)
        m2 = f.wmul(z1, z2)
        sxy = f.wsub(f.wsub(f.wmul(f.wadd_lazy(x1, y1), f.wadd_lazy(x2, y2)), m0), m1)
        syz = f.wsub(f.wsub(f.wmul(f.wadd_lazy(y1, z1), f.wadd_lazy(y2, z2)), m1), m2)
        sxz = f.wsub(f.wsub(f.wmul(f.wadd_lazy(x1, z1), f.wadd_lazy(x2, z2)), m0), m2)
        w = f.wsmall(f.wsub(sxz, f.wmul(b, m2)), 3)
        zc = f.wsub_lazy(m1, w)
        xc = f.wadd_lazy(m1, w)
        v = f.wsmall(f.wsub(f.wsub(f.wmul(b, sxz), f.wsmall(m2, 3)), m0), 3)
        u = f.wsmall(f.wsub(m0, m2), 3)
        x3 = f.wsub(f.wmul(sxy, xc), f.wmul(syz, v))
        y3 = f.wadd(f.wmul(xc, zc), f.wmul(u, v))
        z3 = f.wadd(f.wmul(syz, zc), f.wmul(sxy, u))
        return torch.stack([x3, y3, z3], dim=-2)

    def _wdbl(self, P):
        f = self.f
        b = self._const(self.b, P.device)
        x, y, z = P.unbind(-2)
        xx = f.wmul(x, x)
        yy = f.wmul(y, y)
        zz = f.wmul(z, z)
        xy2 = f.wsmall(f.wmul(x, y), 2)
        xz2 = f.wsmall(f.wmul(x, z), 2)
        yz2 = f.wsmall(f.wmul(y, z), 2)
        w = f.wsmall(f.wsub(f.wmul(b, zz), xz2), 3)
        zc = f.wsub_lazy(yy, w)
        xc = f.wadd_lazy(yy, w)
        v = f.wsmall(f.wsub(f.wsub(f.wmul(b, xz2), f.wsmall(zz, 3)), xx), 3)
        u = f.wsmall(f.wsub(xx, zz), 3)
        x3 = f.wsub(f.wmul(xy2, zc), f.wmul(yz2, v))
        y3 = f.wadd(f.wmul(xc, zc), f.wmul(u, v))
        z3 = f.wsmall(f.wmul(yz2, yy), 4)
        return torch.stack([x3, y3, z3], dim=-2)

    def comb8_entries(self, bases: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """The comb table from its window bases: [..., 32, 3, 9] ->
        (canonical, Montgomery) [..., 32, 256, 3, 9], entry [j][d] the
        affine point d * 2^(8j) * base as (x, y, 1); d = 0 is the identity
        (0, 1, 0).  The Montgomery form (x * 2^288 mod p, the identity
        (0, 2^288 mod p, 0)) is made with Python integers
        (:meth:`FieldT.pack_mont`)."""
        f = self.f
        x, y, inf = self._comb8_affine(bases)
        one = f.const(1, bases.device)
        y = torch.where(inf[..., None], one, f.canon(y))
        z = torch.where(inf[..., None], torch.zeros_like(one), one)
        canon = torch.stack([f.canon(x), y, z.expand_as(y)], dim=-2)
        return canon, f.pack_mont(f.unpack(canon), bases.device).reshape(canon.shape)

    def comb_table(self, P: torch.Tensor) -> "WeierComb":
        """The comb table of a base, [3, 9] -> a :class:`WeierComb` of
        [32, 256, 3, 9] (reference ``curve_ops.py:307 comb_table``, there
        projective, here affine): :meth:`comb8_bases`, then
        :meth:`comb8_entries`."""
        canon, mont = self.comb8_entries(self.comb8_bases(P))
        return WeierComb(canon, mont)

    def neg(self, P: torch.Tensor) -> torch.Tensor:
        return torch.stack([P[..., 0, :], self.f.neg(P[..., 1, :]), P[..., 2, :]], dim=-2)

    def is_identity(self, P: torch.Tensor) -> torch.Tensor:
        """(X:Y:Z) == (0:1:0), canonical coordinates: Z == 0."""
        return self.f.is_zero(P[..., 2, :])


class EdwardsOps(CurveOps):
    """Twisted Edwards extended coordinates (X:Y:T:Z); identity (0:1:0:1).
    HWCD08 unified formulas (reference ``EdwardsOps``)."""

    NCOORD = 4
    MIXED_NC = 5  # comb rows: X2, Y2, X2+Y2, d*T2, a*X2

    def __init__(self, field: FieldT, a: int, d: int, group, curve_id: int) -> None:
        super().__init__(field, group)
        self.a = a
        self.d = d
        self.curve_id = curve_id

    def identity_ints(self) -> list[int]:
        return [0, 1, 0, 1]

    def _host_coords(self, pt) -> list[int]:
        return [pt.x, pt.y, pt.t, pt.z]

    def _host_point(self, c):
        from ..curves.edwards import TEdwardsPoint

        return TEdwardsPoint(self.group, *c)

    def _finish(self, E, F, G, H):
        f = self.f
        return torch.stack([f.wmul(E, F), f.wmul(G, H), f.wmul(E, H), f.wmul(F, G)], dim=-2)

    def _wadd(self, P, Q):
        f = self.f
        x1, y1, t1, z1 = P.unbind(-2)
        x2, y2, t2, z2 = Q.unbind(-2)
        A = f.wmul(x1, x2)
        B = f.wmul(y1, y2)
        C = f.wmul(self._const(self.d, P.device), f.wmul(t1, t2))
        D = f.wmul(z1, z2)
        E = f.wsub_lazy(f.wsub(f.wmul(f.wadd_lazy(x1, y1), f.wadd_lazy(x2, y2)), A), B)
        F = f.wsub_lazy(D, C)
        G = f.wadd_lazy(D, C)
        H = f.wsub_lazy(B, f.wmul(self._const(self.a, P.device), A))
        return self._finish(E, F, G, H)

    def _wdbl(self, P):
        f = self.f
        x, y, _, z = P.unbind(-2)
        A = f.wmul(x, x)
        B = f.wmul(y, y)
        C = f.wsmall(f.wmul(z, z), 2)
        D = f.wmul(self._const(self.a, P.device), A)
        xy = f.wadd_lazy(x, y)
        E = f.wsub_lazy(f.wsub(f.wmul(xy, xy), A), B)
        G = f.wadd(D, B)
        F = f.wsub_lazy(G, C)
        H = f.wsub_lazy(D, B)
        return self._finish(E, F, G, H)

    def _wadd_mixed(self, P, T):
        f = self.f
        x1, y1, t1, z1 = P.unbind(-2)
        tx, ty, txy, tdt, tax = T.unbind(-2)
        A = f.wmul(x1, tx)
        B = f.wmul(y1, ty)
        C = f.wmul(t1, tdt)
        E = f.wsub_lazy(f.wsub(f.wmul(f.wadd_lazy(x1, y1), txy), A), B)
        F = f.wsub_lazy(z1, C)
        G = f.wadd_lazy(z1, C)
        H = f.wsub_lazy(B, f.wmul(x1, tax))
        return self._finish(E, F, G, H)

    def add_mixed(self, P: torch.Tensor, T: torch.Tensor) -> torch.Tensor:
        """P (extended [..., 4, 9]) + T (comb rows [..., 5, 9])."""
        return self._canon(self._wadd_mixed(self._work(P), self._work(T)))

    def mul_comb_mixed(self, comb: torch.Tensor, d8: torch.Tensor) -> torch.Tensor:
        """Fixed-base multiply from mixed comb tables [D, 256, 5, 9]
        (several bases' tables concatenated along D) and LSB-first byte
        digits [..., D] -> [..., 4, 9]: one add_mixed per window, in
        window order."""
        d = d8.to(torch.int64)
        acc = self._work(self.identity(d.shape[:-1], comb.device))
        for j in range(comb.shape[0]):
            acc = self._wadd_mixed(acc, self._work(comb[j][d[..., j]]))
        return self._canon(acc)

    def comb8_entries(self, bases: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """The mixed-add comb table from its window bases: [..., 32, 4, 9]
        -> (canonical, Montgomery) [..., 32, 256, 5, 9], entry [j][d] the
        rows (x, y, x+y, d*x*y, a*x) of the affine point d * 2^(8j) * base
        (reference ``curve_ops.py:666 comb_table_mixed``); d = 0 is the
        affine identity (0, 1).  The Montgomery form (x * 2^288 mod p) is
        made with Python integers (:meth:`FieldT.pack_mont`)."""
        f = self.f
        x, y, _ = self._comb8_affine(bases)
        dev = bases.device
        rows = torch.stack([
            x, y, f.wadd(x, y),
            f.wmul(self._const(self.d, dev), f.wmul(x, y)),
            f.wmul(self._const(self.a, dev), x),
        ], dim=-2)
        canon = self._canon(rows)
        return canon, f.pack_mont(f.unpack(canon), dev).reshape(canon.shape)

    def comb_table_mixed(self, P: torch.Tensor) -> "MixedComb":
        """The mixed-add comb tables of R bases [R, 4, 9] -> a
        :class:`MixedComb` of [R * 32, 256, 5, 9] (each base's 32 windows
        in turn): :meth:`comb8_bases`, then :meth:`comb8_entries`."""
        canon, mont = self.comb8_entries(self.comb8_bases(P))
        shape = (-1, COMB_ENTRIES, self.MIXED_NC, NLIMBS)
        return MixedComb(canon.reshape(shape), mont.reshape(shape))

    def comb_rows(self, x: int, y: int) -> list[int]:
        """The five mixed-add rows of one affine point (x, y)."""
        p = self.f.p
        return [x, y, (x + y) % p, self.d * (x * y % p) % p, self.a * x % p]

    def neg(self, P: torch.Tensor) -> torch.Tensor:
        f = self.f
        return torch.stack(
            [f.neg(P[..., 0, :]), P[..., 1, :], f.neg(P[..., 2, :]), P[..., 3, :]], dim=-2
        )

    def is_identity(self, P: torch.Tensor) -> torch.Tensor:
        """(X:Y:T:Z) == (0:1:0:1) projectively, canonical coordinates:
        X == 0 and Y == Z."""
        f = self.f
        return f.is_zero(P[..., 0, :]) & f.equal(P[..., 1, :], P[..., 3, :])


def _make_ops():
    from ..curves import instances as inst

    p256_ops = WeierOps(P256_P, inst.p256.b, inst.p256, 0)
    war_ops = WeierOps(WAR_P, inst.war256.b, inst.war256, 1)
    tom_ops = EdwardsOps(
        TOM_P, inst.tomEdwards256.a, inst.tomEdwards256.d, inst.tomEdwards256, 2
    )
    return p256_ops, tom_ops, war_ops


p256_ops, tom_ops, war_ops = _make_ops()


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _check_points(ops: CurveOps, *ts: torch.Tensor) -> None:
    for t in ts:
        if t.device.type != "cuda":
            raise ValueError(f"kernel operand on {t.device}, expected a CUDA tensor")
        if t.dtype != torch.int32 or tuple(t.shape[-2:]) != (ops.NCOORD, NLIMBS):
            raise ValueError(
                f"expected int32 [..., {ops.NCOORD}, {NLIMBS}] points, got "
                f"{t.dtype} {tuple(t.shape)}"
            )


def _aligned(d: torch.Tensor) -> torch.Tensor:
    """Contiguous digits whose rows start on 16-byte boundaries: the comb
    kernels and msm_ladder load a row's digits 16 bytes at a time (rows of
    32, 64 or 256)."""
    d = d.contiguous()
    return d if d.data_ptr() % 16 == 0 else d.clone()


def ec_add(ops: CurveOps, P: torch.Tensor, Q: torch.Tensor) -> torch.Tensor:
    """Complete point addition over canonical [..., C, 9] points (batch
    dims broadcast).  Kernel ``csrc/ec.cu`` (replaces
    ``zkecdsa_tpu/ops/pallas_field.py:214 pallas_ec_add``), a team of four
    lanes a pair; bound by 32-bit integer multiply-adds.  A CPU tensor
    takes ``ops.add``."""
    if P.device.type == "cpu":
        return ops.add(P, Q)
    lib = _build.load()
    _check_points(ops, P, Q)
    P, Q = (t.contiguous() for t in torch.broadcast_tensors(P, Q))
    out = torch.empty_like(P)
    B = P.numel() // (ops.NCOORD * NLIMBS)
    code = lib.zk_ec_add(ops.curve_id, B, P.data_ptr(), Q.data_ptr(), out.data_ptr(), _stream(P))
    _build.check(code, "zk_ec_add")
    ec_add.launches += 1
    return out


ec_add.launches = 0


# Warps of to_affine chains an SM runs at once under the plan: one a
# scheduler.  One chain of dependent Montgomery products keeps a
# scheduler's INT32 pipe most of the way busy, so a second warp there
# nearly doubles both chains' time: on the H100, Tom-256 [10240, 39] took
# 0.386 ms at 16,640 threads (g = 24) and 0.483 ms at 33,280 (g = 12),
# though g = 12 does 15% fewer products a chain
# (tools/torch_affine_sweep.py; PERF.md).
_AFFINE_WARPS_PER_SM = 4


def affine_threads(ops: CurveOps, device) -> int:
    """Threads of :func:`to_affine`'s kernel that keep a CUDA device busy
    without more chains than it needs: its SMs times
    ``_AFFINE_WARPS_PER_SM`` warps, at most the warps the card holds
    (C entry ``zk_to_affine_resident_warps``, the kernel's occupancy)."""
    index = _index(device)
    sms = torch.cuda.get_device_properties(index).multi_processor_count
    resident = _resident_warps("zk_to_affine_resident_warps", index, ops.curve_id)
    return min(resident, sms * _AFFINE_WARPS_PER_SM) * 32


@dataclasses.dataclass(frozen=True)
class AffinePlan:
    """Launch geometry of :func:`to_affine` for B points: ``threads``
    threads, thread t inverting the group of points t, t + threads, ...
    (at most ``group`` of them) with one Fermat inverse."""

    group: int
    threads: int


def affine_plan(B: int, threads: int, group: int | None = None) -> AffinePlan:
    """The smallest group that lets B points run on at most ``threads``
    threads (:func:`affine_threads`): while B fits, a point a thread (its
    inverse chain sets the time, and more work a thread would only
    lengthen it); beyond, g points a thread, so the inverses' work falls
    by g while the chains in flight stay enough to fill the card.
    ``group`` forces the group size (tests and chip_smoke.py)."""
    if group is None:
        group = max(1, -(-B // max(1, threads)))
    if group < 1:
        raise ValueError(f"to_affine groups hold at least one point, not {group}")
    return AffinePlan(group, max(1, -(-B // group)))


def to_affine(ops: CurveOps, P: torch.Tensor, group: int | None = None):
    """(x, y, is_infinity) of canonical [..., C, 9] points; infinity gives
    (0, 0).  Kernel ``csrc/ec.cu`` (replaces ``curve_ops.py:459
    to_affine`` + ``canon``): Montgomery's trick over groups of points,
    one Fermat inverse a group, geometry from :func:`affine_plan`
    (``group`` forces it; tests and chip_smoke.py only).  A CPU tensor
    takes ``ops.to_affine``."""
    if P.device.type == "cpu":
        return ops.to_affine(P)
    lib = _build.load()
    _check_points(ops, P)
    P = P.contiguous()
    batch = P.shape[:-2]
    x = torch.empty(batch + (NLIMBS,), dtype=torch.int32, device=P.device)
    y = torch.empty_like(x)
    inf = torch.empty(batch, dtype=torch.uint8, device=P.device)
    B = inf.numel()
    plan = affine_plan(B, affine_threads(ops, P.device), group)
    code = lib.zk_to_affine(
        ops.curve_id, B, plan.threads, P.data_ptr(), x.data_ptr(), y.data_ptr(),
        inf.data_ptr(), _stream(P),
    )
    _build.check(code, "zk_to_affine")
    to_affine.launches += 1
    return x, y, inf.bool()


to_affine.launches = 0


# Rows of the phase-B chord pass (see :func:`chord`), all mod TOM_N: the
# inputs per row beside T1, then the outputs.
CHORD_IN = (
    "pkx", "pky", "txv", "pky_r", "txr",
    "cb0", "cb1", "cb2", "cb3", "kx0", "kx1", "kx2", "kx3",
)
CHORD_OUT = (
    ("t1x", "t1y", "i7", "i8", "i9", "i10", "i11", "i12", "i13")
    + tuple(f"ext_vals{j}" for j in range(8)) + tuple(f"ext_blinds{j}" for j in range(8))
)


def chord_plain(T1: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version of :func:`chord`, on any device: the
    P-256 affine pass of T1 (``p256_ops.to_affine``), then the chord pass
    with its own inverse."""
    f = TOM_N
    t1x, t1y, _ = p256_ops.to_affine(T1)
    pkx, pky, txv, pky_r, txr, cb0, cb1, cb2, cb3, *kx = f.to_work(x).unbind(-2)
    wx, wy = f.to_work(t1x), f.to_work(t1y)
    i7 = f.wsub(pkx, wx)
    i8 = f.winv(i7)
    i9 = f.wsub(pky, wy)
    i10 = f.wmul(i8, i9)
    i11 = f.wmul(i10, i10)
    i12 = f.wsub(wx, txv)
    i13 = f.wmul(i10, i12)
    ys = [i8, i9, i10, i12]
    xs = [i7, i8, i10, i10]
    rb = [cb2, f.wsub(pky_r, cb1), cb3, f.wsub(cb0, txr)]
    out = (
        [wx, wy, i7, i8, i9, i10, i11, i12, i13]
        + [f.wmul(a, b) for a, b in zip(xs, ys)]
        + [f.wmul(a, b) for a, b in zip(kx, ys)]
        + [f.wmul(a, b) for a, b in zip(xs, rb)]
        + [f.wmul(a, b) for a, b in zip(kx, rb)]
    )
    return f.canon(torch.stack(out, dim=-2))


def chord(T1: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Phase B's affine pass of T1 and its field pass of the point-add
    sub-proofs, per row and mod TOM_N (the Tom-256 order, which is the
    P-256 base prime, so P-256 coordinates carry over unchanged): T1
    [K, 3, 9] canonical projective P-256 points and x [K, 13, 9] canonical
    rows in the order of ``CHORD_IN`` -> [K, 25, 9] canonical, in the
    order of ``CHORD_OUT``:

    * t1x, t1y, T1's affine coordinates ((0, 0) for the identity);
    * the chord-rule intermediates (pointAdd.ts:119-136)
      i7 = pkx - t1x, i8 = i7^-1 (0 maps to 0), i9 = pky - t1y,
      i10 = i8 i9, i11 = i10^2, i12 = t1x - txv, i13 = i10 i12;
    * ext_vals x_j y_j, then kx_j y_j, and ext_blinds x_j rb_j, then
      kx_j rb_j, with y = [i8, i9, i10, i12], x = [i7, i8, i10, i10],
      rb = [cb2, pky_r - cb1, cb3, cb0 - txr].

    Kernel ``csrc/chord.cu`` (replaces ``zkecdsa_tpu/ops/f32field.py:441
    batch_inv`` and the field pass of ``protocol/batch.py:464-493``, with
    the affine pass of T1 before it, ``nist_affine_std`` at ``:463``): one
    thread per row and one Fermat inverse a row for both of the row's
    inversions (1/Z and 1/i7); the inverses are unique, so the integers
    are the plain version's.  A CPU tensor takes :func:`chord_plain`."""
    if x.device.type == "cpu":
        return chord_plain(T1, x)
    lib = _build.load()
    _check_points(p256_ops, T1)
    _check_limbs(x)
    K = x.shape[0]
    if x.dim() != 3 or x.shape[1] != len(CHORD_IN) or tuple(T1.shape) != (K, 3, NLIMBS):
        raise ValueError(
            f"expected T1 [K, 3, 9] and rows [K, {len(CHORD_IN)}, 9], got {tuple(T1.shape)}, "
            f"{tuple(x.shape)}"
        )
    T1, x = T1.contiguous(), x.contiguous()
    out = torch.empty((K, len(CHORD_OUT), NLIMBS), dtype=torch.int32, device=x.device)
    code = lib.zk_chord(K, T1.data_ptr(), x.data_ptr(), out.data_ptr(), _stream(x))
    _build.check(code, "zk_chord")
    chord.launches += 1
    return out


chord.launches = 0


_TREE_MAX = 64  # points of a tree_sum column in shared memory (csrc/ec.cu TREE_MAX)


def tree_sum(ops: CurveOps, P: torch.Tensor) -> torch.Tensor:
    """Sum of canonical points [n, ..., C, 9] along axis 0 -> [..., C, 9],
    in the plain tree's order (level by level, pairs (i, i + n/2), an odd
    level carrying its last point), so the integers are
    ``ops.sum_reduce``'s.  Kernel ``csrc/ec.cu`` (replaces
    ``zkecdsa_tpu/ops/curve_ops.py:274 sum_reduce``, a level of adds at a
    time): one launch a tree for n <= 64, a block a column; a larger n
    first runs the tree's levels as :func:`ec_add` launches, one a level,
    until it fits.  n = 0 gives the identity and n = 1 the point, with no
    launch.  A CPU tensor takes ``ops.sum_reduce``."""
    if P.device.type == "cpu":
        return ops.sum_reduce(P)
    n = P.shape[0]
    if n == 0:
        return ops.identity(P.shape[1:-2], P.device).contiguous()
    if n == 1:
        return P[0]
    lib = _build.load()
    _check_points(ops, P)
    while n > _TREE_MAX:
        h = n // 2
        P = torch.cat([ec_add(ops, P[:h], P[h : 2 * h]), P[2 * h :]], dim=0)
        n = P.shape[0]
    P = P.contiguous()
    out = torch.empty(P.shape[1:], dtype=torch.int32, device=P.device)
    code = lib.zk_tree_sum(ops.curve_id, n, P.shape[1:-2].numel(), P.data_ptr(), out.data_ptr(), _stream(P))
    _build.check(code, "zk_tree_sum")
    tree_sum.launches += 1
    return out


tree_sum.launches = 0


def sum_reduce(ops: CurveOps, P: torch.Tensor, axis: int = 0) -> torch.Tensor:
    """Tree sum of points along an axis through :func:`tree_sum`: exactly
    n-1 adds, an odd width carries its last element up a level."""
    return tree_sum(ops, P.movedim(axis, 0))


_FOLD_TEAMS = 64  # teams of one block, folded in shared memory (msm.cu MAX_TEAMS)


@functools.lru_cache(maxsize=None)
def _resident_warps(entry: str, index: int, *args) -> int:
    """Warps of one kernel that CUDA device ``index`` holds at once: its
    SMs times the warps an SM holds, which the C entry ``entry`` reads
    from the occupancy calculator (the kernel's registers and shared
    memory)."""
    lib = _build.load()
    warps = ctypes.c_int()
    with torch.cuda.device(index):
        code = getattr(lib, entry)(*args, ctypes.byref(warps))
    _build.check(code, entry)
    return torch.cuda.get_device_properties(index).multi_processor_count * warps.value


def _index(device) -> int:
    device = torch.device(device)
    return torch.cuda.current_device() if device.index is None else device.index


def straus_teams(ops: CurveOps, device) -> int:
    """Teams of four lanes that :func:`straus_msm`'s kernel keeps resident
    on a CUDA device at once: the one-warp blocks of the kernel the card
    holds, eight teams a warp."""
    return _resident_warps("zk_straus_resident_warps", _index(device), ops.curve_id) * 8


@dataclasses.dataclass(frozen=True)
class StrausPlan:
    """Launch geometry of :func:`straus_msm` for R rows of T terms: one
    team per (row, chunk of ``chunk`` terms), ``nchunks`` chunks a row;
    ``group`` teams of a row fold their sums in one block, giving
    ``nparts`` sums a row; a block holds ``rows_per_block`` such parts
    (csrc/msm.cu rounds its threads up to whole warps)."""

    chunk: int
    nchunks: int
    group: int
    nparts: int
    rows_per_block: int


def straus_plan(R: int, T: int, teams: int) -> StrausPlan:
    """The fewest terms per team that still let R * nchunks teams fit the
    ``teams`` the card keeps resident at once (:func:`straus_teams`): a
    team's chain is its terms' table builds (14 adds each), 256 doublings
    and 64 adds a term, so fewer terms give shorter chains while the teams
    fit, and a second wave would double the time.  A row of up to 64
    chunks is one part (folded in its block, no :func:`tree_sum` launch);
    small parts share a block of at least one warp."""
    want = max(1, teams // max(1, R))
    chunk = -(-T // min(T, want)) if T else 1
    nchunks = -(-T // chunk) if T else 0
    group = max(1, min(nchunks, _FOLD_TEAMS))
    nparts = -(-nchunks // group)
    return StrausPlan(chunk, nchunks, group, nparts, max(1, 8 // group))


def straus_table_bytes(ops: CurveOps, R: int, T: int) -> int:
    """Scratch bytes :func:`straus_msm` needs for its window tables."""
    return R * T * TABLE * ops.NCOORD * NLIMBS * 4


def straus_msm(ops: CurveOps, points: torch.Tensor, digits: torch.Tensor) -> torch.Tensor:
    """Per row, sum_t s_t * P_t: points [R, T, C, 9] canonical, digits
    [R, T, 64] MSB-first nibbles (uint8) -> [R, C, 9].

    Kernel ``csrc/msm.cu`` (replaces ``zkecdsa_tpu/ops/curve_ops.py:393
    msm_shared``): one team of four lanes per chunk of terms, geometry from
    :func:`straus_plan`; the chunks of a row fold in the kernel, and only
    a row of more than 64 chunks leaves parts that :func:`sum_reduce`
    adds with :func:`tree_sum`.  The kernel adds in another order than the
    reference's schedule, so its projective coordinates differ from
    ``ops.msm_shared``'s; the group element is the same.  A CPU tensor
    takes ``ops.msm_shared``."""
    if points.device.type == "cpu":
        return ops.msm_shared(points, digits)
    lib = _build.load()
    _check_points(ops, points)
    R, T = points.shape[0], points.shape[1]
    if digits.shape != (R, T, NDIGITS_256) or digits.dtype != torch.uint8:
        raise ValueError(f"expected uint8 digits [{R}, {T}, 64], got {digits.dtype} {tuple(digits.shape)}")
    if digits.device != points.device:
        raise ValueError("points and digits on different devices")
    if R * T == 0:
        return ops.identity((R,), points.device).contiguous()
    points, digits = points.contiguous(), digits.contiguous()
    plan = straus_plan(R, T, straus_teams(ops, points.device))
    table = torch.empty(
        straus_table_bytes(ops, R, T) // 4, dtype=torch.int32, device=points.device
    )
    parts = torch.empty((R, plan.nparts, ops.NCOORD, NLIMBS), dtype=torch.int32, device=points.device)
    code = lib.zk_straus_msm(
        ops.curve_id, R, T, plan.chunk, plan.group, plan.rows_per_block, points.data_ptr(),
        digits.data_ptr(), table.data_ptr(), parts.data_ptr(), _stream(points),
    )
    _build.check(code, "zk_straus_msm")
    straus_msm.launches += 1
    return sum_reduce(ops, parts, axis=1)


straus_msm.launches = 0


def msm(ops: CurveOps, points: torch.Tensor, digits: torch.Tensor) -> torch.Tensor:
    """sum_t s_t * P_t over one set of terms: points [T, C, 9] canonical,
    MSB-first nibbles [T, 64] (uint8) -> [C, 9].  Replaces
    ``zkecdsa_tpu/ops/curve_ops.py:289 msm`` (per-term window multiplies,
    then a tree sum): the same function as a Straus MSM of one row, so a
    CUDA tensor goes to :func:`straus_msm` on [1, T] (no kernel of its
    own).  A CPU tensor takes ``ops.msm``, the reference's schedule."""
    if points.device.type == "cpu":
        return ops.msm(points, digits)
    return straus_msm(ops, points[None], digits[None])[0]


def msm_ladder(ops: CurveOps, points: torch.Tensor, bits: torch.Tensor) -> torch.Tensor:
    """Per row, sum_t s_t * P_t by a double-and-add ladder per term: points
    [..., T, C, 9] canonical, MSB-first bits [..., T, 256] (uint8) ->
    [..., C, 9].

    Kernel ``csrc/ladder.cu`` (replaces ``zkecdsa_tpu/ops/curve_ops.py:373
    msm_ladder``): a team of four lanes a term runs its 256 steps (a
    doubling, an add, a select on the bit) in the plain version's order,
    reading the term's bits 16 bytes at a time; the terms of a row are
    then tree-summed with :func:`sum_reduce`, the plain version's tree, so
    the projective coordinates are the plain version's.  A CPU tensor
    takes ``ops.msm_ladder``."""
    if points.device.type == "cpu":
        return ops.msm_ladder(points, bits)
    lib = _build.load()
    _check_points(ops, points)
    if tuple(bits.shape) != tuple(points.shape[:-2]) + (256,) or bits.dtype != torch.uint8:
        raise ValueError(
            f"expected uint8 bits {tuple(points.shape[:-2]) + (256,)}, got {bits.dtype} {tuple(bits.shape)}"
        )
    if bits.device != points.device:
        raise ValueError("points and bits on different devices")
    points, bits = points.contiguous(), _aligned(bits)
    B = bits.shape[:-1].numel()
    terms = torch.empty_like(points)
    if B:
        code = lib.zk_msm_ladder(
            ops.curve_id, B, points.data_ptr(), bits.data_ptr(), terms.data_ptr(), _stream(points),
        )
        _build.check(code, "zk_msm_ladder")
        msm_ladder.launches += 1
    return sum_reduce(ops, terms, axis=-3)


msm_ladder.launches = 0


@dataclasses.dataclass(frozen=True)
class MixedComb:
    """The Tom-256 mixed-add comb tables of g then h, [64, 256, 5, 9]
    (entry [j][d] = the rows X, Y, X+Y, d*T, a*X of d * 2^(8j) * base,
    windows 0..31 of g, then 0..31 of h), in two forms of the same
    values: ``canon``, canonical standard form (the plain version's and
    the reference's, ``carry.py``), and ``mont``, x * 2^288 mod p (the
    kernel's Montgomery form, so it converts no entry).  Built once per
    parameter set (``protocol.batch.DeviceParams``, :func:`comb_table_mixed`)."""

    canon: torch.Tensor
    mont: torch.Tensor

    @classmethod
    def pack(cls, values) -> "MixedComb":
        """Flat Python ints, in the table's order, -> both forms (CPU)."""
        f, shape = tom_ops.f, (-1, 256, EdwardsOps.MIXED_NC, NLIMBS)
        return cls(f.pack(values).reshape(shape), f.pack_mont(values).reshape(shape))

    def to(self, device) -> "MixedComb":
        return MixedComb(self.canon.to(device), self.mont.to(device))


@dataclasses.dataclass(frozen=True)
class WeierComb:
    """The P-256 comb table of one base, [32, 256, 3, 9] (entry [j][d] =
    the affine point d * 2^(8j) * base as (x, y, 1), the identity (0, 1,
    0) for d = 0), in two forms of the same values: ``canon``, canonical
    standard form (the plain version's, the tests' and ``carry.py``'s),
    and ``mont``, x * 2^288 mod p (the form :func:`comb_weier`'s kernel
    reads, so it converts no entry).  Built once per parameter set
    (``protocol.batch.DeviceParams``, :func:`comb_table`).  A sibling of
    :class:`MixedComb`, not the same class: the entries differ in kind
    (points, not mixed-add rows) and each wrapper checks that it was
    given the table its kernel reads."""

    canon: torch.Tensor
    mont: torch.Tensor

    def to(self, device) -> "WeierComb":
        return WeierComb(self.canon.to(device), self.mont.to(device))


_COMB_THREADS = 128  # threads of a comb block (csrc/comb.cuh COMB_THREADS)


def comb_resident(device, kernel: str) -> int:
    """Rows that the one-lane kernel of ``kernel`` (:func:`comb_mixed`,
    :func:`comb_weier` or :func:`mul_comb4`) keeps resident on a CUDA
    device at once: the warps of the kernel the card holds (C entry
    ``zk_<kernel>_resident_warps``), 32 rows a warp."""
    return _resident_warps(f"zk_{kernel}_resident_warps", _index(device)) * 32


@dataclasses.dataclass(frozen=True)
class CombPlan:
    """Launch geometry of a comb kernel (:func:`comb_mixed`,
    :func:`comb_weier`, :func:`mul_comb4`) for B rows: ``lanes`` lanes a
    row (4, a team, or 1), ``rows_per_block`` rows in each of ``blocks``
    blocks of 128 threads."""

    lanes: int
    rows_per_block: int
    blocks: int


def comb_plan(B: int, resident: int, lanes: int | None = None) -> CombPlan:
    """A team of four lanes a row when the B rows, one lane each, leave
    the card under-filled (B < ``resident``, the kernel's
    :func:`comb_resident`): a row's chain is then the call's time, and
    the team runs a window in fewer rounds than the lane's products (a
    Tom-256 mixed add in 3 rounds instead of 9, a P-256 add in 5 instead
    of 14).  One lane a row when the rows fill the card: there the
    instruction count sets the time, and the team's exchanges and its
    every-lane product cost more than its shorter chain saves.  ``lanes``
    forces the geometry (tests and chip_smoke.py)."""
    if lanes is None:
        lanes = 4 if B < resident else 1
    if lanes not in (1, 4):
        raise ValueError(f"a comb kernel runs 1 or 4 lanes a row, not {lanes}")
    rows = _COMB_THREADS // lanes
    return CombPlan(lanes, rows, -(-B // rows))


def comb_mixed(comb: MixedComb, d8: torch.Tensor, lanes: int | None = None) -> torch.Tensor:
    """g*v + h*r on Tom-256: the comb tables of g then h and LSB-first byte
    digits [..., 64] (uint8; v's 32 then r's 32) -> [..., 4, 9] canonical.
    Kernel ``csrc/comb.cu`` (replaces ``curve_ops.py:731
    double_mul_comb_mixed``) on ``comb.mont``, the tables in Montgomery
    form, geometry from :func:`comb_plan` (``lanes`` forces it; tests and
    chip_smoke.py only); the output is canonical standard form.  A CPU
    tensor takes ``tom_ops.mul_comb_mixed`` on ``comb.canon``."""
    if d8.device.type == "cpu":
        return tom_ops.mul_comb_mixed(comb.canon, d8)
    lib = _build.load()
    tabs = comb.mont
    if tuple(tabs.shape) != (64, 256, EdwardsOps.MIXED_NC, NLIMBS) or tabs.dtype != torch.int32:
        raise ValueError(f"expected int32 [64, 256, 5, 9] tables, got {tabs.dtype} {tuple(tabs.shape)}")
    if d8.dtype != torch.uint8 or d8.shape[-1] != 64:
        raise ValueError(f"expected uint8 [..., 64] digits, got {d8.dtype} {tuple(d8.shape)}")
    if tabs.device != d8.device or d8.device.type != "cuda":
        raise ValueError("comb_mixed operands must be on one CUDA device")
    tabs, d8 = tabs.contiguous(), _aligned(d8)
    batch = d8.shape[:-1]
    out = torch.empty(batch + (4, NLIMBS), dtype=torch.int32, device=d8.device)
    B = batch.numel()
    plan = comb_plan(B, comb_resident(d8.device, "comb_mixed"), lanes)
    code = lib.zk_comb_mixed(B, plan.lanes, tabs.data_ptr(), d8.data_ptr(), out.data_ptr(), _stream(d8))
    _build.check(code, "zk_comb_mixed")
    comb_mixed.launches += 1
    return out


comb_mixed.launches = 0


def window_table(ops: CurveOps, P: torch.Tensor) -> torch.Tensor:
    """[..., C, 9] canonical points -> [..., 16, C, 9] window tables of
    their multiples 0..15: entry k = entry k-1 + P from the identity, the
    plain version's order, so the projective coordinates are the same
    integers.  Kernel ``csrc/ec.cu`` (replaces
    ``zkecdsa_tpu/ops/curve_ops.py:133 table``), one launch a call: a
    team of four lanes a point runs its chain of 15 adds.  A CPU tensor
    takes ``ops.table``."""
    if P.device.type == "cpu":
        return ops.table(P)
    lib = _build.load()
    _check_points(ops, P)
    P = P.contiguous()
    out = torch.empty(P.shape[:-2] + (TABLE,) + P.shape[-2:], dtype=torch.int32, device=P.device)
    B = P.shape[:-2].numel()
    code = lib.zk_window_table(ops.curve_id, B, P.data_ptr(), out.data_ptr(), _stream(P))
    _build.check(code, "zk_window_table")
    window_table.launches += 1
    return out


window_table.launches = 0


_P256_TABLE = (TABLE, 3, NLIMBS)  # one P-256 window table


def _check_digits(d: torch.Tensor, width: int, name: str) -> None:
    if d.dtype != torch.uint8 or d.shape[-1] != width or d.device.type != "cuda":
        raise ValueError(
            f"expected CUDA uint8 [..., {width}] {name}, got {d.dtype} {tuple(d.shape)} on {d.device}"
        )


def _table_rows(t: torch.Tensor, batch: torch.Size) -> tuple[torch.Tensor, int]:
    """A window-table operand of :func:`shamir` as (contiguous rows, row
    stride in limbs): one shared table has stride 0."""
    if tuple(t.shape[-3:]) != _P256_TABLE or t.dtype != torch.int32 or t.device.type != "cuda":
        raise ValueError(f"expected CUDA int32 [..., 16, 3, 9] tables, got {t.dtype} {tuple(t.shape)}")
    if t.shape[:-3].numel() == 1:
        rows, stride = t.reshape(_P256_TABLE).contiguous(), 0
    else:
        rows, stride = t.expand(batch + t.shape[-3:]).contiguous(), TABLE * 3 * NLIMBS
    # the kernel copies the tables in 16-byte pieces
    return (rows if rows.data_ptr() % 16 == 0 else rows.clone()), stride


def shamir(tp: torch.Tensor, dP: torch.Tensor, tq: torch.Tensor, dQ: torch.Tensor) -> torch.Tensor:
    """dP*P + dQ*Q on P-256 from window tables tp, tq [..., 16, 3, 9] and
    MSB-first nibbles dP, dQ [..., 64] (uint8; batch dims broadcast) ->
    [..., 3, 9].  Kernel ``csrc/shamir.cu`` (replaces
    ``zkecdsa_tpu/ops/curve_ops.py:238 double_mul_tables``), the same
    operation order as the plain version, so the projective coordinates
    are the same.  A CPU tensor takes ``p256_ops.double_mul_tables``."""
    if dP.device.type == "cpu":
        return p256_ops.double_mul_tables(tp, dP, tq, dQ)
    lib = _build.load()
    _check_digits(dP, NDIGITS_256, "digits")
    _check_digits(dQ, NDIGITS_256, "digits")
    batch = torch.broadcast_shapes(tp.shape[:-3], tq.shape[:-3], dP.shape[:-1], dQ.shape[:-1])
    (tp, sp), (tq, sq) = _table_rows(tp, batch), _table_rows(tq, batch)
    dP = dP.expand(batch + (NDIGITS_256,)).contiguous()
    dQ = dQ.expand(batch + (NDIGITS_256,)).contiguous()
    out = torch.empty(batch + (3, NLIMBS), dtype=torch.int32, device=dP.device)
    code = lib.zk_shamir(
        batch.numel(), tp.data_ptr(), sp, dP.data_ptr(), tq.data_ptr(), sq, dQ.data_ptr(),
        out.data_ptr(), _stream(dP),
    )
    _build.check(code, "zk_shamir")
    shamir.launches += 1
    return out


shamir.launches = 0


def comb4_table(P: torch.Tensor, canon: bool = False) -> torch.Tensor:
    """Per-base 4-bit comb tables of P-256 points: [..., 3, 9] ->
    [..., 64, 16, 3, 9], entry [j][d] = d * 16^(63-j) * P (replaces
    ``curve_ops.py:194 comb4_table``): :func:`comb4_bases`, then
    :func:`comb4_entries`.  The table is in the form :func:`mul_comb4`
    takes on the same device: a CPU tensor takes ``p256_ops.comb4_table``,
    canonical; on the card it is in Montgomery form unless ``canon``
    (tests and chip_smoke.py)."""
    if P.device.type == "cpu":
        return p256_ops.comb4_table(P)
    return comb4_entries(comb4_bases(P), canon)


def comb4_bases(P: torch.Tensor) -> torch.Tensor:
    """The position bases of :func:`comb4_table`: [..., 3, 9] -> [..., 64,
    3, 9], entry j = 16^(63-j) * P.  Kernel ``csrc/comb4.cu``: a team of
    four lanes per base runs the serial chain of 252 doublings in the
    plain version's order.  A CPU tensor takes ``p256_ops.comb4_bases``."""
    if P.device.type == "cpu":
        return p256_ops.comb4_bases(P)
    lib = _build.load()
    _check_points(p256_ops, P)
    P = P.contiguous()
    out = torch.empty(P.shape[:-2] + (NDIGITS_256, 3, NLIMBS), dtype=torch.int32, device=P.device)
    code = lib.zk_comb4_bases(P.shape[:-2].numel(), P.data_ptr(), out.data_ptr(), _stream(P))
    _build.check(code, "zk_comb4_bases")
    comb4_bases.launches += 1
    return out


comb4_bases.launches = 0


def comb4_entries(bases: torch.Tensor, canon: bool = False) -> torch.Tensor:
    """The comb tables from their canonical position bases: [..., 64, 3,
    9] -> [..., 64, 16, 3, 9].  Kernel ``csrc/comb4.cu``: a team of four
    lanes per (base, position) builds the 16 entries in the plain
    version's order, keeping them in shared memory, and writes them in
    Montgomery form (x * 2^288 mod p), the form
    :func:`mul_comb4`'s kernel reads, or canonical if ``canon`` (tests and
    chip_smoke.py).  A CPU tensor takes ``p256_ops.comb4_entries``,
    canonical."""
    if bases.device.type == "cpu":
        return p256_ops.comb4_entries(bases)
    lib = _build.load()
    _check_points(p256_ops, bases)
    if bases.dim() < 3 or bases.shape[-3] != NDIGITS_256:
        raise ValueError(f"expected [..., 64, 3, 9] position bases, got {tuple(bases.shape)}")
    bases = bases.contiguous()
    out = torch.empty(bases.shape[:-2] + _P256_TABLE, dtype=torch.int32, device=bases.device)
    code = lib.zk_comb4_entries(
        bases.shape[:-3].numel(), int(not canon), bases.data_ptr(), out.data_ptr(), _stream(bases)
    )
    _build.check(code, "zk_comb4_entries")
    comb4_entries.launches += 1
    return out


comb4_entries.launches = 0


def mul_comb4(tab: torch.Tensor, digits: torch.Tensor, lanes: int | None = None) -> torch.Tensor:
    """S scalars per base from per-base comb tables: tab [..., 64, 16, 3,
    9] and MSB-first nibbles [..., S, 64] (uint8, the same leading dims) ->
    [..., S, 3, 9] canonical; 64 gather-adds per scalar from the row's own
    table.  Kernel ``csrc/comb4.cu`` (replaces ``curve_ops.py:218
    mul_comb4``) on a table in Montgomery form, as :func:`comb4_table`
    gives it on the card, in the plain version's order, a team of four
    lanes or one lane a scalar by :func:`comb_plan` (``lanes`` forces it;
    tests and chip_smoke.py only).  A CPU tensor takes
    ``p256_ops.mul_comb4`` on a canonical table, as :func:`comb4_table`
    gives it on the CPU."""
    if digits.device.type == "cpu":
        return p256_ops.mul_comb4(tab, digits)
    lib = _build.load()
    _check_digits(digits, NDIGITS_256, "digits")
    lead = digits.shape[:-2]
    if tuple(tab.shape) != tuple(lead) + (NDIGITS_256,) + _P256_TABLE or tab.dtype != torch.int32:
        raise ValueError(f"expected int32 {tuple(lead)} + [64, 16, 3, 9] tables, got {tab.dtype} {tuple(tab.shape)}")
    if tab.device != digits.device:
        raise ValueError("tables and digits on different devices")
    tab, digits = tab.contiguous(), _aligned(digits)
    S = digits.shape[-2]
    out = torch.empty(digits.shape[:-1] + (3, NLIMBS), dtype=torch.int32, device=digits.device)
    plan = comb_plan(lead.numel() * S, comb_resident(digits.device, "mul_comb4"), lanes)
    code = lib.zk_mul_comb4(
        lead.numel(), S, plan.lanes, tab.data_ptr(), digits.data_ptr(), out.data_ptr(), _stream(digits)
    )
    _build.check(code, "zk_mul_comb4")
    mul_comb4.launches += 1
    return out


mul_comb4.launches = 0


def comb_weier(comb: WeierComb, d8: torch.Tensor, lanes: int | None = None) -> torch.Tensor:
    """Fixed-base multiply on P-256 from a comb table and LSB-first byte
    digits [..., 32] (uint8) -> [..., 3, 9] canonical: one complete add
    per window, in window order.  Kernel ``csrc/comb.cu`` (replaces
    ``curve_ops.py:330 mul_comb``) on ``comb.mont``, the table in
    Montgomery form, geometry from :func:`comb_plan` (``lanes`` forces
    it; tests and chip_smoke.py only).  A CPU tensor takes
    ``p256_ops.mul_comb`` on ``comb.canon``.  ``comb`` is a
    :class:`WeierComb`: a bare tensor raises, so a canonical table never
    reaches the kernel."""
    if not isinstance(comb, WeierComb):
        raise TypeError(f"comb_weier takes a WeierComb (both forms of the table), not {type(comb).__name__}")
    if d8.device.type == "cpu":
        return p256_ops.mul_comb(comb.canon, d8)
    lib = _build.load()
    tab = comb.mont
    _check_digits(d8, COMB_WINDOWS, "byte digits")
    if tuple(tab.shape) != (COMB_WINDOWS, COMB_ENTRIES, 3, NLIMBS) or tab.dtype != torch.int32:
        raise ValueError(f"expected int32 [32, 256, 3, 9] tables, got {tab.dtype} {tuple(tab.shape)}")
    if tab.device != d8.device:
        raise ValueError("table and digits on different devices")
    tab, d8 = tab.contiguous(), _aligned(d8)
    out = torch.empty(d8.shape[:-1] + (3, NLIMBS), dtype=torch.int32, device=d8.device)
    B = out.shape[:-2].numel()
    plan = comb_plan(B, comb_resident(d8.device, "comb_weier"), lanes)
    code = lib.zk_comb_weier(B, plan.lanes, tab.data_ptr(), d8.data_ptr(), out.data_ptr(), _stream(d8))
    _build.check(code, "zk_comb_weier")
    comb_weier.launches += 1
    return out


comb_weier.launches = 0


def comb8_bases(ops: CurveOps, P: torch.Tensor) -> torch.Tensor:
    """The window bases of comb tables: canonical [R, C, 9] -> [R, 32, C,
    9], entry j = 2^(8j) * P (LSB-first, as byte digits are).  Kernel
    ``csrc/comb8.cu`` (replaces the window-base scan of
    ``zkecdsa_tpu/ops/curve_ops.py:307 comb_table``): a team of four lanes
    per base runs the serial chain of 248 doublings in the plain version's
    order, so the projective coordinates are the same.  A CPU tensor takes
    ``ops.comb8_bases``."""
    if P.device.type == "cpu":
        return ops.comb8_bases(P)
    lib = _build.load()
    _check_points(ops, P)
    if P.dim() != 3:
        raise ValueError(f"expected [R, {ops.NCOORD}, 9] bases, got {tuple(P.shape)}")
    P = P.contiguous()
    out = torch.empty((P.shape[0], COMB_WINDOWS, ops.NCOORD, NLIMBS), dtype=torch.int32, device=P.device)
    code = lib.zk_comb8_bases(ops.curve_id, P.shape[0], P.data_ptr(), out.data_ptr(), _stream(P))
    _build.check(code, "zk_comb8_bases")
    comb8_bases.launches += 1
    return out


comb8_bases.launches = 0


def comb8_entries(ops: CurveOps, bases: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The comb tables from their window bases [R, 32, C, 9], as
    (canonical, Montgomery): for P-256 the affine table [R, 32, 256, 3, 9]
    (identity (0, 1, 0)); for Tom-256 the mixed-add rows [R, 32, 256, 5,
    9].  Kernel ``csrc/comb8.cu`` (replaces the entries of
    ``zkecdsa_tpu/ops/curve_ops.py:307 comb_table`` and the affine rows of
    ``:666 comb_table_mixed``): one block a window builds the 256 entries
    in shared memory in the plain version's order, then converts each to
    affine with a Fermat inverse.  A CPU tensor takes
    ``ops.comb8_entries``."""
    if bases.device.type == "cpu":
        return ops.comb8_entries(bases)
    lib = _build.load()
    _check_points(ops, bases)
    if bases.dim() != 4 or bases.shape[1] != COMB_WINDOWS:
        raise ValueError(f"expected [R, 32, {ops.NCOORD}, 9] window bases, got {tuple(bases.shape)}")
    bases = bases.contiguous()
    R = bases.shape[0]
    nc = EdwardsOps.MIXED_NC if isinstance(ops, EdwardsOps) else ops.NCOORD
    canon = torch.empty((R, COMB_WINDOWS, COMB_ENTRIES, nc, NLIMBS), dtype=torch.int32, device=bases.device)
    mont = torch.empty_like(canon)
    code = lib.zk_comb8_entries(
        ops.curve_id, R, bases.data_ptr(), canon.data_ptr(), mont.data_ptr(), _stream(bases)
    )
    _build.check(code, "zk_comb8_entries")
    comb8_entries.launches += 1
    return canon, mont


comb8_entries.launches = 0


def comb_table(P: torch.Tensor) -> WeierComb:
    """The P-256 comb table of one base: canonical [3, 9] -> a
    :class:`WeierComb` of [32, 256, 3, 9], entry [j][d] the affine point
    d * 2^(8j) * P, (0, 1, 0) for d = 0 (replaces
    ``zkecdsa_tpu/ops/curve_ops.py:307 comb_table``, whose table is
    projective): :func:`comb8_bases`, then :func:`comb8_entries`, which
    writes both forms.  A CPU tensor takes ``p256_ops.comb_table``."""
    if P.device.type == "cpu":
        return p256_ops.comb_table(P)
    canon, mont = comb8_entries(p256_ops, comb8_bases(p256_ops, P[None]))
    return WeierComb(canon[0], mont[0])


def comb_table_mixed(P: torch.Tensor) -> MixedComb:
    """The Tom-256 mixed-add comb tables of R bases: canonical [R, 4, 9] ->
    a :class:`MixedComb` of [R * 32, 256, 5, 9] (replaces
    ``zkecdsa_tpu/ops/curve_ops.py:666 comb_table_mixed``, one base a
    call): :func:`comb8_bases`, then :func:`comb8_entries`, which writes
    both forms.  A CPU tensor takes ``tom_ops.comb_table_mixed``."""
    if P.device.type == "cpu":
        return tom_ops.comb_table_mixed(P)
    canon, mont = comb8_entries(tom_ops, comb8_bases(tom_ops, P))
    shape = (-1, COMB_ENTRIES, EdwardsOps.MIXED_NC, NLIMBS)
    return MixedComb(canon.reshape(shape), mont.reshape(shape))
