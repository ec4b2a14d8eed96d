"""The batch verifier's MSM rows as flat integer arithmetic (the stage
``verify.assemble`` of :class:`~.batch_verify.BatchVerifier`).

The object path (``curves/multimult.py``) folds each sigma-protocol check
into a ``Relation``, draws its weight with one call to the random source,
scales every term through a ``Scalar`` and merges it into a ``MultiMult``;
hashing a challenge serialises each projective point through its own
inversion.  A batch of 256 proofs makes ~78,000 relations that way.  Here
the same algebra runs on plain integers over the whole batch:

1. the five Tom-256 points each sampled bit-0 round computes (C7, C9, C12,
   RX+PX+QX, PY+RY; pointAdd.ts:199-259) with the HWCD formulas of
   ``TEdwardsPoint.add``, and their affine forms from one batch inversion;
2. the challenges: each one's message, the bytes ``hash_points`` would
   hash (a point read from the wire has Z = 1 and needs no inversion),
   then one ``native.sha256_batch`` over them all;
3. the weights: one ``big.rnd_many`` over the modulus of every relation of
   the batch, in the object path's order, so one call to the source, and
   the bytes the object path's ``rnd`` loop would consume;
4. each relation's terms, scaled by its weight, added into its row.

Rows merge as ``MultiMult`` merges: the known points first, then by object
identity, and a point not placed yet also by value against the known
points.  A point read from the wire may carry a coordinate at or above p
(the Python parser checks the curve equation mod p and no range), so
values and encodings reduce mod p, as ``to_affine`` does.  The wire names
each point's and scalar's group, and ``MultiMult``/``Relation`` raise on
one of the other curve; here such a proof is not ``ok`` and draws
nothing.  A negation ``X.neg()`` with scalar s is the term (X, -s), so no
point is built for it.  Each row thus holds the points of
``MultiMult.pairs()`` in the same order, a negated term's point un-negated
and its scalar negated.  The scalar verifier and every other ``MultiMult``
user keep the object path, which mirrors the reference relation by
relation; ``tests/test_torch_assemble.py`` holds the two paths to each
other.
"""

from __future__ import annotations

from ..bignum import big
from ..curves.edwards import TEdwardsPoint
from ..curves.instances import p256
from ..curves.weier import WeierstrassPoint
from ..runtime import native
from ..utils import profiling

__all__ = ["affine_points", "assemble_rows", "encode"]

# relations a proof drains, after its 2n + 1 GK relations: a sampled bit-1
# round's relA (P-256), relTx and relTy; a bit-0 round's relA, then the
# point addition's four product proofs (5 each) and two equalities (2 each)
_BIT0_W = 4 * 5 + 2 * 2


def _affine(pt, p: int):
    """Affine (x, y) mod p, None for the P-256 identity: the key a point's
    value is compared by.  Points read from the wire have Z = 1."""
    return (pt.x % p, pt.y % p) if pt.z == 1 else pt.to_affine()


def _ed_add(p, a, d, x1, y1, t1, z1, x2, y2, t2, z2):
    """``TEdwardsPoint.add`` (HWCD08 unified addition) on integers."""
    A = x1 * x2 % p
    B = y1 * y2 % p
    C = d * t1 % p * t2 % p
    D = z1 * z2 % p
    E = ((x1 + y1) * (x2 + y2) - A - B) % p
    F = (D - C) % p
    G = (D + C) % p
    H = (B - a * A) % p
    return E * F % p, G * H % p, E * H % p, F * G % p


def _batch_inv(vals: list[int], p: int) -> list[int]:
    """Inverses mod the prime p by Montgomery's trick, one ``pow`` in all;
    0 maps to 0, as ``big.inv_mod`` maps it."""
    pre = []
    acc = 1
    for v in vals:
        pre.append(acc)
        if v:
            acc = acc * v % p
    inv = pow(acc, -1, p)
    out = [0] * len(vals)
    for k in range(len(vals) - 1, -1, -1):
        v = vals[k]
        if v:
            out[k] = inv * pre[k] % p
            inv = inv * v % p
    return out


def affine_points(group, pts: list[tuple[int, int, int]]) -> list[TEdwardsPoint]:
    """Projective Tom-256 points ``(X, Y, Z)`` as point objects with Z = 1,
    from one batch inversion."""
    p = group.p
    inv = _batch_inv([z for _, _, z in pts], p)
    return [TEdwardsPoint(group, x * zi % p, y * zi % p, None, 1) for (x, y, _), zi in zip(pts, inv)]


def encode(pt, p: int, nbytes: int) -> bytes:
    """``pt.to_bytes()``, with no inversion where Z = 1."""
    if pt.z != 1:
        return pt.to_bytes()
    return b"\x04" + (pt.x % p).to_bytes(nbytes, "big") + (pt.y % p).to_bytes(nbytes, "big")


def _groups_hold(pr, idxs, bits, tom: str, nist: str) -> bool:
    """Whether every point and scalar that assembly reads from the proof
    is of its field's curve (by name, as ``Group.eq`` compares): Tom-256
    for the GK and point-addition proofs, ``keyXcom``, ``keyYcom``, ``Tx``,
    ``Ty``, ``beta2`` and ``beta3``; P-256 for ``R``, ``comS1``, ``A``,
    ``beta1`` and ``z2``."""
    mp = pr.membershipProof
    tw = [pr.keyXcom, pr.keyYcom, *mp.cl, *mp.ca, *mp.cb, *mp.cd, *mp.f, *mp.za, *mp.zb, mp.zd]
    nw = [pr.R, pr.comS1]
    for r, b in zip(idxs, bits):
        rp = pr.expProof[r]
        nw.append(rp.A)
        tw += (rp.Tx, rp.Ty)
        if b:
            nw.append(rp.beta1)
            tw += (rp.beta2, rp.beta3)
            continue
        nw.append(rp.z2)
        pi = rp.proof
        tw += (pi.C_8, pi.C_10, pi.C_11, pi.C_13)
        for m in (pi.pi_8, pi.pi_10, pi.pi_11, pi.pi_13):
            tw += (m.C_4, m.A_x, m.A_y, m.A_z, m.A_4_1, m.A_4_2, m.t_x, m.t_y, m.t_z, m.t_rx, m.t_ry, m.t_rz, m.t_r4)
        for e in (pi.pi_x, pi.pi_y):
            tw += (e.A_1, e.A_2, e.t_x, e.t_r1, e.t_r2)
    return all(v.group.name == tom for v in tw) and all(v.group.name == nist for v in nw)


class _Row:
    """One proof's MSM row on one curve while it is assembled: its points,
    their scalars (unreduced), and where ``MultiMult`` would merge a point."""

    __slots__ = ("pts", "acc", "ids", "known", "coords", "neg", "p")

    def __init__(self, known, neg, p: int) -> None:
        self.p = p
        self.pts: list = []
        self.acc: list[int] = []
        self.ids: dict[int, int] = {}
        self.known: dict = {}  # affine value -> slot, the known points
        self.coords: set[int] = set()  # their coordinates
        self.neg = neg  # affine value -> the negation's
        for pt in known:  # MultiMult.add_known: a value already known is skipped
            key = _affine(pt, p)
            if key not in self.known:
                self.known[key] = self.ids[id(pt)] = len(self.pts)
                self.coords.update(key or ())
                self.pts.append(pt)
                self.acc.append(0)

    def _known_slot(self, pt, negated: bool):
        """The slot of the known point equal to ``pt`` (to ``-pt``), or
        None.  A negation keeps one affine coordinate, so a point sharing
        neither with a known point matches none."""
        key = _affine(pt, self.p)
        if key is None:
            return self.known.get(None)
        if key[0] not in self.coords and key[1] not in self.coords:
            return None
        return self.known.get(self.neg(*key) if negated else key)

    def slot(self, pt) -> int:
        """``MultiMult.insert``'s slot for ``pt``: by identity, then by
        value among the known points, else a new one.  Only a point placed
        in a slot of its own is recorded by identity: it stays alive, so its
        id is not reused."""
        s = self.ids.get(id(pt))
        if s is None:
            s = self._known_slot(pt, False)
            if s is None:
                s = self.ids[id(pt)] = len(self.pts)
                self.pts.append(pt)
                self.acc.append(0)
        return s

    def add_neg(self, pt, v: int) -> None:
        """The term (-pt, v): into a known point's slot where -pt is one,
        else a slot of its own holding (pt, -v); ``pt.neg()`` would be a new
        object, so its identity matches nothing."""
        s = self._known_slot(pt, True)
        if s is None:
            self.pts.append(pt)
            self.acc.append(-v)
        else:
            self.acc[s] += v


def assemble_rows(
    params, proofs, ok, n, gk_x, totals, idxs, bits,
    t0x, t0y, t0inf, sxs, sys_, cinf, comx, comy, pos0, pos1,
):
    """The rows ``(points, scalars)`` of every proof, Tom-256 then P-256,
    from the device phase's outputs (``BatchVerifier._verify``'s names:
    ``idxs``, ``bits`` its sampled rounds, ``t0x``... the unpacked
    coordinates, ``totals`` the GK recombination).  A proof not ``ok``
    gets empty rows; so does one whose sampled T or T1 is at infinity, or
    that holds a point or scalar of the other curve, which is marked not
    ``ok``.  Neither draws a weight.

    Under a tracer it counts ``assemble.proofs`` (proofs assembled) and
    ``assemble.hashes`` (challenges); ``rnd_many`` counts the weights
    (``rnd.calls``)."""
    pg = params.proof_group
    tom, g, h = pg.c, pg.g, pg.h
    h_n = params.nist_group.h
    o_w, o_n = tom.order, p256.order
    p, a, d = tom.p, tom.a, tom.d
    pn = p256.p
    fb = tom.size_field_bytes()
    N = len(proofs)
    S = len(idxs[0]) if N else 0

    tn, nn = tom.name, p256.name
    todo = []
    for i in range(N):
        if ok[i] and (cinf[i].any() or not _groups_hold(proofs[i], idxs[i], bits[i], tn, nn)):
            ok[i] = False  # T (or T1) at infinity, or a point of the other curve
        if ok[i]:
            todo.append(i)
    # the sampled bit-0 rounds, in the walk's order: (proof, round)
    rounds0 = [(i, j) for i in todo for j in range(S) if not bits[i][j]]

    # ---- 1. the bit-0 rounds' computed points, one batch inversion ----
    xyz: list[tuple[int, int, int]] = []
    for i, j in rounds0:
        pr = proofs[i]
        qx, qy = pr.keyXcom, pr.keyYcom
        rp = pr.expProof[idxs[i][j]]
        k0 = pos0[i, j]
        x1, y1 = comx[2 * k0], comy[2 * k0]  # PX = T1x
        x2, y2 = comx[2 * k0 + 1], comy[2 * k0 + 1]  # PY = T1y
        t1, t2 = x1 * y1 % p, x2 * y2 % p
        rx, ry = rp.Tx, rp.Ty
        for P in (
            _ed_add(p, a, d, qx.x, qx.y, qx.t, qx.z, -x1 % p, y1, -t1 % p, 1),  # C7 = QX - PX
            _ed_add(p, a, d, qy.x, qy.y, qy.t, qy.z, -x2 % p, y2, -t2 % p, 1),  # C9 = QY - PY
            _ed_add(p, a, d, x1, y1, t1, 1, -rx.x % p, rx.y, -rx.t % p, rx.z),  # C12 = PX - RX
            _ed_add(p, a, d, *_ed_add(p, a, d, rx.x, rx.y, rx.t, rx.z, x1, y1, t1, 1),
                    qx.x, qx.y, qx.t, qx.z),  # RX + PX + QX
            _ed_add(p, a, d, x2, y2, t2, 1, ry.x, ry.y, ry.t, ry.z),  # PY + RY
        ):
            xyz.append((P[0], P[1], P[3]))
    comp = affine_points(tom, xyz)

    # ---- 2. the challenges: six a bit-0 round, one hash batch ----
    e_g = encode(g, p, fb)

    def mult_msg(e_x, e_y, e_z, pi) -> bytes:
        return b"".join((e_x, e_y, e_z, encode(pi.C_4, p, fb), encode(pi.A_x, p, fb), encode(pi.A_y, p, fb),
                         encode(pi.A_z, p, fb), encode(pi.A_4_1, p, fb), encode(pi.A_4_2, p, fb)))

    def eq_msg(e_1, e_2, pi) -> bytes:
        return b"".join((e_1, e_2, encode(pi.A_1, p, fb), encode(pi.A_2, p, fb)))

    msgs: list[bytes] = []
    for c, (i, j) in enumerate(rounds0):
        pi = proofs[i].expProof[idxs[i][j]].proof
        C7, C9, C12, SX, SY = comp[5 * c : 5 * c + 5]
        e8, e10, e11, e13 = (encode(C, p, fb) for C in (pi.C_8, pi.C_10, pi.C_11, pi.C_13))
        msgs += (
            mult_msg(encode(C7, p, fb), e8, e_g, pi.pi_8),
            mult_msg(e8, encode(C9, p, fb), e10, pi.pi_10),
            mult_msg(e10, e10, e11, pi.pi_11),
            eq_msg(e11, encode(SX, p, fb), pi.pi_x),
            mult_msg(e10, encode(C12, p, fb), e13, pi.pi_13),
            eq_msg(e13, encode(SY, p, fb), pi.pi_y),
        )
    ch_next = iter([big.from_bytes(dg[:10]) for dg in native.sha256_batch(msgs)]).__next__

    # ---- 3. the weights, one draw ----
    gk_mods = [o_w] * (2 * n + 1)
    mods_1, mods_0 = [o_n, o_w, o_w], [o_n] + [o_w] * _BIT0_W
    moduli: list[int] = []
    for i in todo:
        moduli += gk_mods
        for b in bits[i]:
            moduli += mods_1 if b else mods_0
    w_next = iter(big.rnd_many(moduli)).__next__

    # ---- 4. every relation's terms, scaled by its weight, into its row ----
    def mult(W, Cx, Cy, Cz, pi) -> None:
        """aggregate_mult's five relations (mult.ts:148-175)."""
        c = ch_next()
        w1, w2, w3, w4, w5 = w_next(), w_next(), w_next(), w_next(), w_next()
        acc, slot, add_neg = W.acc, W.slot, W.add_neg
        tx, tz = pi.t_x.k, pi.t_z.k
        acc[sg] += w1 * tx + w2 * pi.t_y.k + (w3 + w4) * tz
        acc[sh] += w1 * pi.t_rx.k + w2 * pi.t_ry.k + w3 * pi.t_rz.k + w4 * pi.t_r4.k
        acc[slot(Cx)] += w1 * c
        add_neg(pi.A_x, w1)
        acc[slot(Cy)] += w2 * c + w5 * tx
        add_neg(pi.A_y, w2)
        acc[slot(Cz)] += w3 * c
        add_neg(pi.A_z, w3)
        acc[slot(pi.C_4)] += (w4 + w5) * c
        add_neg(pi.A_4_1, w4)
        add_neg(pi.A_4_2, w5)

    def equality(W, C1, C2, pi) -> None:
        """aggregate_equality's two relations (equality.ts:94-116)."""
        c = ch_next()
        w1, w2 = w_next(), w_next()
        acc = W.acc
        acc[sg] += (w1 + w2) * pi.t_x.k
        acc[sh] += w1 * pi.t_r1.k + w2 * pi.t_r2.k
        acc[W.slot(C1)] += w1 * c
        W.add_neg(pi.A_1, w1)
        acc[W.slot(C2)] += w2 * c
        W.add_neg(pi.A_2, w2)

    def neg_w(x, y):
        return (-x % p, y)

    def neg_n(x, y):
        return (x, -y % pn)

    rows_w: list = [([], []) for _ in range(N)]
    rows_n: list = [([], []) for _ in range(N)]
    r0 = 0  # the next bit-0 round's computed points
    for i in todo:
        pr = proofs[i]
        W = _Row((g, h), neg_w, p)
        Nr = _Row((pr.R, h_n, pr.comS1), neg_n, pn)
        accw, accn = W.acc, Nr.acc
        # the known points' slots: each term of theirs lands there
        sg, sh = W.slot(g), W.slot(h)
        s_hn, s_s1 = Nr.slot(h_n), Nr.slot(pr.comS1)
        # GK: the bit relations, then the final one (gk.ts:223-259)
        mp = pr.membershipProof
        x = gk_x[i]
        for j in range(n):
            w0, w1 = w_next(), w_next()
            f = mp.f[j].k
            accw[W.slot(mp.cl[j])] += w0 * x
            accw[W.slot(mp.ca[j])] += w0
            accw[sg] -= w0 * f
            accw[sh] -= w0 * mp.za[j].k
            accw[W.slot(mp.cl[j])] += w1 * (x - f)
            accw[W.slot(mp.cb[j])] += w1
            accw[sh] -= w1 * mp.zb[j].k
        w = w_next()
        xj = 1
        for j in range(n):
            accw[W.slot(mp.cd[j])] -= w * xj
            xj = xj * x % o_w
        accw[W.slot(pr.keyXcom)] += w * xj
        accw[sg] -= w * totals[i]
        accw[sh] -= w * mp.zd.k
        # the sampled exp rounds (exp.ts:263-346)
        for j in range(S):
            rp = pr.expProof[idxs[i][j]]
            k = i * S + j
            T = p256.identity() if t0inf[i, j] else WeierstrassPoint(p256, t0x[k], t0y[k], 1)
            w = w_next()
            accn[Nr.slot(T)] += w
            if bits[i][j]:
                accn[s_hn] += w * rp.beta1.k
                Nr.add_neg(rp.A, w)
                k1 = pos1[i, j]
                w = w_next()
                accw[sg] += w * sxs[k1]
                accw[sh] += w * rp.beta2.k
                W.add_neg(rp.Tx, w)
                w = w_next()
                accw[sg] += w * sys_[k1]
                accw[sh] += w * rp.beta3.k
                W.add_neg(rp.Ty, w)
                continue
            accn[s_s1] += w
            Nr.add_neg(rp.A, w)
            accn[s_hn] += w * rp.z2.k
            # aggregate_point_add (pointAdd.ts:199-259): PX, PY = T1x, T1y,
            # QX, QY = keyXcom, keyYcom, RX, RY = Tx, Ty; C14 = g
            C7, C9, C12, SX, SY = comp[r0 : r0 + 5]
            r0 += 5
            pi = rp.proof
            mult(W, C7, pi.C_8, g, pi.pi_8)
            mult(W, pi.C_8, C9, pi.C_10, pi.pi_10)
            mult(W, pi.C_10, pi.C_10, pi.C_11, pi.pi_11)
            equality(W, pi.C_11, SX, pi.pi_x)
            mult(W, pi.C_10, C12, pi.C_13, pi.pi_13)
            equality(W, pi.C_13, SY, pi.pi_y)
        rows_w[i] = (W.pts, [v % o_w for v in accw])
        rows_n[i] = (Nr.pts, [v % o_n for v in accn])
    if profiling.TRACER is not None:
        profiling.count("assemble.proofs", len(todo))
        profiling.count("assemble.hashes", len(msgs))
    return rows_w, rows_n

