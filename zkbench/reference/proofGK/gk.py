"""Groth-Kohlweiss one-out-of-many membership proof (L3b).

Proves a commitment opens to a value equal to the ``index``-th entry of a
public list, with O(log N) proof size (Groth-Kohlweiss, eprint 2014/764;
reference src/proofGK/gk.ts).

Structure:
  * the ring is padded to 2^n by repeating element 0 (gk.ts:75-86);
  * per index-bit commitments cl, ca, cb plus degree-(n-1) correction
    commitments cd;
  * the d-polynomial values at n points come from an O(n*N) product
    table - the hot loop for large rings;
  * one 80-bit challenge over cl || ca || cb || cd (the reference's
    challenge deliberately omits the statement, gk.ts:178 - reproduced for
    wire compatibility);
  * verification is 2n bit-proof Relations plus one final Relation whose
    scalar "total" is the O(N*n) ring recombination (gk.ts:239-250).
"""

from __future__ import annotations

from ..bignum import big
from ..commit.pedersen import Commitment, PedersenParams
from ..curves.group import Group, Point, Scalar, hash_points
from ..curves.multimult import MultiMult, Relation
from .interpolate import interpolate

__all__ = ["GKProof", "prove_membership", "verify_membership"]

_FIELDS = ("cl", "ca", "cb", "cd", "f", "za", "zb", "zd")


class GKProof:
    """(gk.ts:31-73)."""

    __slots__ = _FIELDS

    def __init__(self, cl, ca, cb, cd, f, za, zb, zd) -> None:
        self.cl = cl
        self.ca = ca
        self.cb = cb
        self.cd = cd
        self.f = f
        self.za = za
        self.zb = zb
        self.zd = zd

    def eq(self, o: "GKProof") -> bool:
        def arr_eq(a, b):
            return len(a) == len(b) and all(x.eq(y) for x, y in zip(a, b))

        return (
            arr_eq(self.cl, o.cl)
            and arr_eq(self.ca, o.ca)
            and arr_eq(self.cb, o.cb)
            and arr_eq(self.cd, o.cd)
            and arr_eq(self.f, o.f)
            and arr_eq(self.za, o.za)
            and arr_eq(self.zb, o.zb)
            and self.zd.eq(o.zd)
        )


def _pad(vals: list[int], c: Group) -> list[Scalar]:
    """Pad to a power of two by repeating element 0 (gk.ts:75-86)."""
    ret = [c.new_scalar(v) for v in vals]
    pad_len = 1 << (len(vals) - 1).bit_length() if len(vals) > 1 else 1
    ret.extend(ret[0] for _ in range(pad_len - len(vals)))
    return ret


def gk_statement_bind(x: int, com_pt: Point, values: list[Scalar]) -> int:
    """Statement binding for the GK challenge (hardened mode).

    The reference deliberately omits the statement from the challenge
    (gk.ts:178 "TODO: hash in the statement as well"); the default keeps
    that quirk for wire compatibility.  With ``Config.hardened_gk`` the
    commitment point and the (padded) public ring values are folded into
    the 80-bit challenge, so a proof binds to ONE statement.  Prover and
    verifier both read the flag - hardened proofs verify only hardened."""
    from ..utils.config import get_config

    if not get_config().hardened_gk:
        return x
    coord = com_pt.to_affine()
    cx, cy = (0, 0) if coord is None else coord
    return big.hash_nums([x, cx, cy] + [v.k for v in values])


def _commit(params: PedersenParams, val: int, blinder: int) -> Point:
    """g^val * h^blinder (gk.ts:88-92)."""
    order = params.c.order
    return params.g.dblmul(
        params.c.new_scalar(val % order), params.h, params.c.new_scalar(blinder % order)
    )


def prove_membership(
    params: PedersenParams, com: Commitment, index: int, initial_values: list[int]
) -> GKProof:
    """(gk.ts:94-195)."""
    c = params.c
    order = c.order
    values = _pad(initial_values, c)
    n = (len(values) - 1).bit_length() if len(values) > 1 else 0

    eli = [(index >> i) & 1 for i in range(n)]

    ri, ai, si, ti, rho = [], [], [], [], []
    for _ in range(n):
        ri.append(big.rnd(order))
        ai.append(big.rnd(order))
        si.append(big.rnd(order))
        ti.append(big.rnd(order))
        rho.append(big.rnd(order))

    cl = [_commit(params, eli[i], ri[i]) for i in range(n)]
    ca = [_commit(params, ai[i], si[i]) for i in range(n)]
    cb = [_commit(params, eli[i] * ai[i], ti[i]) for i in range(n)]

    # d-polynomial values at omega = 0..n-1 via the f0/f1 ratio-product
    # table: p[idx] = prod_j f_{bit_j(idx)}(omega), built by successive
    # doubling with ratio_j = f1_j / f0_j (gk.ts:135-171).  O(n*N) total.
    omegas = list(range(n))
    dv = []
    for w in omegas:
        f0 = [((1 - eli[j]) * w - ai[j]) % order for j in range(n)]
        f1 = [(eli[j] * w + ai[j]) % order for j in range(n)]
        ratio = [f1[j] * big.inv_mod(f0[j], order) % order for j in range(n)]
        prod = 1
        for v in f0:
            prod = prod * v % order
        p = [prod]
        for j in range(n):
            p += [ratio[j] * pv % order for pv in p]
        dval = 0
        for i, vi in enumerate(values):
            dval = (dval + (values[index].k - vi.k) * p[i]) % order
        dv.append(dval)

    di = interpolate([int(w) for w in omegas], dv, order)
    cd = [_commit(params, di[i], rho[i]) for i in range(n)]

    # Challenge omits the statement by default, matching gk.ts:178;
    # Config.hardened_gk binds it (gk_statement_bind).
    x = gk_statement_bind(hash_points(cl + ca + cb + cd), com.p, values)

    f = [c.new_scalar((eli[i] * x + ai[i]) % order) for i in range(n)]
    za = [c.new_scalar((ri[i] * x + si[i]) % order) for i in range(n)]
    zb = [
        c.new_scalar((ri[i] * (x - f[i].k) + ti[i]) % order) for i in range(n)
    ]
    zd = com.r.k * pow(x, n, order) % order
    for i in range(n):
        zd = (zd - rho[i] * pow(x, i, order)) % order

    return GKProof(cl, ca, cb, cd, f, za, zb, c.new_scalar(zd))


def verify_membership(
    params: PedersenParams, com: Point, init_vec: list[int], proof: GKProof
) -> bool:
    """(gk.ts:197-262)."""
    c = params.c
    order = c.order
    multi = MultiMult(c)
    vec = _pad(init_vec, c)
    n = (len(vec) - 1).bit_length() if len(vec) > 1 else 0
    if any(
        len(arr) != n
        for arr in (proof.cl, proof.ca, proof.cb, proof.cd, proof.f, proof.za, proof.zb)
    ):
        return False
    f = proof.f
    x = gk_statement_bind(
        hash_points(proof.cl + proof.ca + proof.cb + proof.cd), com, vec
    )
    multi.add_known(params.g)
    multi.add_known(params.h)
    one = c.new_scalar(1)
    for i in range(n):
        # the bit proof: cl^x * ca = g^f * h^za  and  cl^(x-f) * cb = h^zb
        rel0 = Relation(c)
        rel0.insert_m(
            [proof.cl[i], proof.ca[i], params.g, params.h],
            [c.new_scalar(x), one, f[i].neg(), proof.za[i].neg()],
        )
        rel0.drain(multi)
        rel1 = Relation(c)
        rel1.insert_m(
            [proof.cl[i], proof.cb[i], params.h],
            [c.new_scalar((x - f[i].k) % order), one, proof.zb[i].neg()],
        )
        rel1.drain(multi)

    # O(N*n) recombination: total = sum_i vec[i] * prod_j (f_j or x - f_j)
    # (gk.ts:239-250).  The batched verifier contracts the ring bit by bit
    # instead (protocol/batch_gk.ring_fold).
    total = 0
    for i, vi in enumerate(vec):
        pix = 1
        for j in range(n):
            if i & (1 << j):
                pix = pix * f[j].k % order
            else:
                pix = pix * (x - f[j].k) % order
        total = (total + vi.k * pix) % order

    rel_final = Relation(c)
    for i in range(n):
        rel_final.insert(proof.cd[i], c.new_scalar(-pow(x, i, order) % order))
    rel_final.insert(com, c.new_scalar(pow(x, n, order)))
    rel_final.insert_m(
        [params.g, params.h], [c.new_scalar(-total % order), proof.zd.neg()]
    )
    rel_final.drain(multi)

    return multi.evaluate().is_identity()
