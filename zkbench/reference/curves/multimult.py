"""Batch-verification MSM accumulator (layer L1).

Role (reference src/curves/multimult.ts): the verifier folds every sigma
protocol check into Relations (sub-equations expected to sum to the group
identity).  ``Relation.drain`` multiplies each relation by an independent
random scalar and merges it into one shared ``MultiMult``; a single
multi-scalar multiplication then checks all equations at once
(random-linear-combination batch verification).

The reference evaluates the MSM with a Bos-Coster max-heap
(multimult.ts:61-145) - sequential and data-dependent.  Here ``evaluate``
uses *shared-window evaluation*: one 4-bit window pass over all scalars
simultaneously, the algorithmic shape of the batched device MSM
(:func:`zkecdsa_tpu_torch.ops.curve_ops.straus_msm`).  The batched
verifier takes the accumulated pairs (:meth:`MultiMult.pairs`) to the
device instead; and when a device backend is installed (see
:func:`set_msm_backend`, :func:`zkecdsa_tpu_torch.protocol.verify.
device_msm_backend`), ``evaluate`` sends an MSM of 8 or more terms to it.
"""

from __future__ import annotations

from typing import Callable, Optional

from .group import Group, Point, Scalar

__all__ = ["MultiMult", "Relation", "set_msm_backend"]

# Optional device MSM: fn(group, points, scalar_ints) -> Point
_MSM_BACKEND: Optional[Callable[[Group, list[Point], list[int]], Point]] = None


def set_msm_backend(
    fn: Optional[Callable[[Group, list[Point], list[int]], Point]],
) -> None:
    global _MSM_BACKEND
    _MSM_BACKEND = fn


class MultiMult:
    """Accumulates (point, scalar) pairs; evaluates sum(s_i * P_i) once.

    ``add_known`` pre-registers frequently used points (generators, Pedersen
    bases) so repeated inserts merge into a single scalar
    (multimult.ts:42-59).
    """

    def __init__(self, group: Group) -> None:
        self.group = group
        self._points: list[Point] = []
        self._scalars: list[Scalar] = []
        self._known: list[tuple[Point, int]] = []
        # identity-merge map: id(point object) -> pair index.  The
        # verifier's aggregations insert the SAME point objects repeatedly
        # (g/h every relation, C_8/C_10/C_13 across sub-proofs, cl[j]
        # across the two GK bit relations); merging them by object
        # identity cuts the final MSM term count ~30% and replaces the
        # per-insert eq() scan over known points (4 bigint muls each)
        # with a dict hit.  Only points stored in ``_points`` enter the
        # map: they stay alive, so their ids cannot be recycled.  A point
        # merged into a known point by value is NOT retained, so its id
        # is never recorded (a later object could reuse that id and be
        # merged into the wrong term).  Value-equal but distinct objects
        # simply stay separate pairs (same MSM result).
        self._by_id: dict[int, int] = {}

    def add_known(self, pt: Point) -> None:
        self.group.is_compat_point(pt)
        if not any(pt.eq(kpt) for kpt, _ in self._known):
            self._points.append(pt)
            self._scalars.append(self.group.new_scalar(0))
            self._known.append((pt, len(self._points) - 1))
            self._by_id[id(pt)] = len(self._points) - 1

    def insert(self, pt: Point, s: Scalar) -> None:
        self.group.is_compat_point(pt)
        self.group.is_compat_scalar(s)
        idx = self._by_id.get(id(pt))
        if idx is not None:
            self._scalars[idx] = self._scalars[idx].add(s)
            return
        for kpt, idx in self._known:
            if pt.eq(kpt):
                self._scalars[idx] = self._scalars[idx].add(s)
                return
        self._points.append(pt)
        self._scalars.append(s)
        self._by_id[id(pt)] = len(self._points) - 1

    def __len__(self) -> int:
        return len(self._points)

    def pairs(self) -> tuple[list[Point], list[int]]:
        """The accumulated (points, scalar ints) - for external batched
        evaluation (one device MSM over many MultiMults)."""
        return list(self._points), [s.k for s in self._scalars]

    def evaluate(self) -> Point:
        if not self._points:
            return self.group.identity()
        if _MSM_BACKEND is not None and len(self._points) >= 8:
            return _MSM_BACKEND(self.group, self._points, [s.k for s in self._scalars])
        return self._evaluate_host()

    def _evaluate_host(self) -> Point:
        """Shared-window MSM: one 16-entry table per point, then a single
        MSB-first nibble sweep; acc = 16*acc + sum_i table_i[digit_i].
        Branchless shape mirroring the device kernel's Straus columns."""
        tables = [pt._window_table() for pt in self._points]
        digit_rows = [_nibbles_fixed(s.k, 64) for s in self._scalars]
        acc = self.group.identity()
        for col in range(64):
            acc = acc.dbl().dbl().dbl().dbl()
            for table, digits in zip(tables, digit_rows):
                d = digits[col]
                if d:
                    acc = acc.add(table[d])
        return acc


def _nibbles_fixed(k: int, width: int) -> list[int]:
    return [(k >> (4 * (width - 1 - i))) & 0xF for i in range(width)]


class Relation:
    """A sub-equation expected to evaluate to the identity
    (multimult.ts:147-174)."""

    def __init__(self, group: Group) -> None:
        self.group = group
        self._points: list[Point] = []
        self._scalars: list[Scalar] = []

    def insert(self, pt: Point, s: Scalar) -> None:
        self.group.is_compat_point(pt)
        self.group.is_compat_scalar(s)
        self._points.append(pt)
        self._scalars.append(s)

    def insert_m(self, pts: list[Point], scalars: list[Scalar]) -> None:
        if len(pts) != len(scalars):
            raise ValueError("arrays are not the same length")
        for pt, s in zip(pts, scalars):
            self.insert(pt, s)

    def drain(self, multi: MultiMult) -> None:
        """Fold into the shared MSM scaled by a fresh random scalar
        (random-linear-combination batch verification,
        multimult.ts:165-173)."""
        randomizer = self.group.random_scalar()
        for pt, s in zip(self._points, self._scalars):
            multi.insert(pt, s.mul(randomizer))
