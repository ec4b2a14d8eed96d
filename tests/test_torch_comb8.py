"""The parameter set-up's comb-table kernels (``csrc/comb8.cu``) on models
in Python integers, and the plain versions against the JAX package.

The kernels have no CPU build, so their new arithmetic is checked here
on models of its steps in Python integers.  The steps are typed out
below; only comb8.cu's constants and the wide doublings' operand codes
are read from the source, so a change to the kernels' arithmetic shows
in the ``cuda`` tests on the card, not here:

* ``fe_inv_vartime`` (a binary extended GCD on nine 32-bit limbs, with
  ``fe_div_2k`` halving the cofactors mod p) against ``pow(a, p - 2, p)``
  on the P-256 and Tom-256 primes, its pass count under ``VT_LIMIT``;
* the window's batch inversion tree (node indices as the kernel has them,
  a zero Z entered as one and its inverse set to 0);
* the schedule of the index-set rounds (eight warps of teams add, a ninth
  doubles m_k ahead), on scalars: every entry written once, from entries
  and doublings already written;
* the 16-lane doublings of ``comb8_bases`` (``wide_weier_dbl``,
  ``wide_edw_dbl``: two rounds, a carried b Z or a X, sums left
  unreduced) against the plain doublings, from the operand codes in the
  source.

tests/test_torch_kernels.py and chip_smoke.py hold the kernels against the
plain versions on the card; tests/test_torch_params.py holds the plain
tables of the parameter set's bases against the JAX package, and the last
test here does so for an identity base and a random one.
"""

import ast
import operator
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zkecdsa_tpu.curves.instances import p256 as jp256
from zkecdsa_tpu.curves.instances import tomEdwards256 as jtom
from zkecdsa_tpu.ops import curve_ops as jcurve
from zkecdsa_tpu_torch import carry
from zkecdsa_tpu_torch.curves.instances import p256, tomEdwards256
from zkecdsa_tpu_torch.ops import curve_ops as tcurve
from zkecdsa_tpu_torch.ops import field as tf

# One intra-op thread: the suite runs several worker processes on the same
# cores, and an oversubscribed OpenMP pool spins instead of working.
torch.set_num_threads(1)

CSRC = Path(tf.__file__).resolve().parents[1] / "csrc"
COMB8 = (CSRC / "comb8.cu").read_text()
PRIMES = {"p256.p": tf.P256_P.p, "tom.p": tf.TOM_P.p}
NL, MASK = tf.NLIMBS, (1 << 32) - 1
_OPS = {ast.Add: operator.add, ast.Sub: operator.sub, ast.Mult: operator.mul, ast.Div: operator.floordiv}


def _constants() -> dict[str, int]:
    """comb8.cu's ``constexpr int`` constants, their expressions (integer
    arithmetic over ZK_NL, ZK_TEAM and the constants before them) evaluated
    on their syntax tree."""
    team = int(re.search(r"#define ZK_TEAM (\d+)", (CSRC / "curve.cuh").read_text()).group(1))
    env = {"ZK_NL": NL, "ZK_TEAM": team}

    def value(node):
        if isinstance(node, ast.Constant):
            return node.value
        if isinstance(node, ast.Name):
            return env[node.id]
        return _OPS[type(node.op)](value(node.left), value(node.right))

    for name, expr in re.findall(r"^constexpr int (\w+) = ([^;]+);", COMB8, re.M):
        env[name] = value(ast.parse(expr, mode="eval").body)
    return env


CONST = _constants()


def _const(name: str) -> int:
    return CONST[name]


VT_LIMIT = _const("VT_LIMIT")


def _div_2k(x: int, t: int, p: int) -> int:
    """fe_div_2k: x / 2^t mod p for 1 <= t <= 32, as the kernel computes it."""
    assert 1 <= t <= 32 and 0 <= x < p
    pinv = -pow(p, -1, 1 << 32) % (1 << 32)
    m = ((x & MASK) * pinv) & (MASK >> (32 - t))
    s = x + m * p
    assert s % (1 << t) == 0 and s < 1 << (32 * (NL + 1))  # ten limbs
    r = s >> t
    assert r < 2 * p  # fe_reduce_once's precondition
    return r - p if r >= p else r


def _strip(u: int, x: int, p: int) -> tuple[int, int]:
    """vt_strip: whole zero limbs (at most nine: 0 stays 0), then the
    trailing zeros of the low one."""
    for _ in range(NL):
        if u & MASK:
            break
        u >>= 32
        x = _div_2k(x, 32, p)
    t = ((u & -u).bit_length() - 1) & 31
    if t > 0:
        u >>= t
        x = _div_2k(x, t, p)
    return u, x


def inv_vartime_model(a: int, p: int) -> tuple[int, int]:
    """fe_inv_vartime on Python integers: (a^-1 mod p, passes).  Raises if
    the loop would run past VT_LIMIT (as it would for a = 0, which no
    caller passes: a zero Z is replaced by one first)."""
    u, v, x1, x2 = a, p, 1, 0
    u, x1 = _strip(u, x1, p)
    for it in range(VT_LIMIT):
        assert x1 * a % p == u % p and x2 * a % p == v % p
        if u >= v:
            if u == v:
                return x1, it
            u, x1 = _strip(u - v, (x1 - x2) % p, p)
        else:
            v, x2 = _strip(v - u, (x2 - x1) % p, p)
    raise AssertionError(f"fe_inv_vartime ran past VT_LIMIT = {VT_LIMIT}")


def _inv_cases(p: int) -> list[int]:
    rs = np.random.RandomState(p % 1000)
    edge = [1, 2, 3, p - 1, p - 2, p // 2] + [1 << k for k in (31, 32, 33, 64, 128, 255) if 1 << k < p]
    return edge + [int.from_bytes(rs.bytes(40), "little") % (p - 1) + 1 for _ in range(64)]


@pytest.mark.parametrize("name", list(PRIMES))
def test_inv_vartime_model_vs_fermat(name):
    """The model of the variable-time inverse equals a^(p-2) at 1, 2, p - 1,
    powers of two and 64 random residues, within its pass limit (at most
    bits(a) + bits(p) - 2: each pass drops a bit of u or v)."""
    p = PRIMES[name]
    for a in _inv_cases(p):
        got, passes = inv_vartime_model(a, p)
        assert got == pow(a, p - 2, p), a
        assert passes <= a.bit_length() + p.bit_length() - 2 <= VT_LIMIT


@pytest.mark.parametrize("name", list(PRIMES))
def test_inv_vartime_zero_is_substituted(name):
    """0 has no inverse: the loop would not meet u = v = 1, so the kernel
    enters one for a zero Z and sets the result to 0, which is Fermat's
    0^(p-2) (here on the window's tree, zero Z beside 1 and p - 1); the
    Montgomery wrapper (from_mont, the inverse, to_mont) gives fe_inv's
    X^-1 R^2 for a Montgomery X."""
    p = PRIMES[name]
    with pytest.raises(AssertionError, match="VT_LIMIT"):
        inv_vartime_model(0, p)
    zs = [0, 1, p - 1, 0] + [2] * 252
    assert tree_inverse_model(zs, p) == [pow(z, p - 2, p) for z in zs]
    R = 1 << 288
    for X in _inv_cases(p)[:8]:
        x = X * pow(R, -1, p) % p  # fe_from_mont
        assert inv_vartime_model(x, p)[0] * R % p == pow(X, -1, p) * R * R % p


def tree_inverse_model(zs: list[int], p: int) -> list[int]:
    """The kernel's batch inversion of a window's 256 Z: leaves 256 + s
    (a zero entered as one), 8 levels of products up (node v = 2v * 2v+1),
    the root's inverse, 8 levels down (inverse of v = inverse of v/2 times
    the product of v ^ 1), the leaves' inverses, zero for a zero Z."""
    n = len(zs)
    assert n == 256
    T = [None] * (2 * n)
    I = [None] * n
    for s, z in enumerate(zs):
        T[n + s] = z if z else 1
    k = n // 2
    while k >= 1:
        for v in range(k, 2 * k):
            T[v] = T[2 * v] * T[2 * v + 1] % p
        k //= 2
    I[1] = inv_vartime_model(T[1], p)[0]
    k = 2
    while k < n:
        for v in range(k, 2 * k):
            I[v] = I[v // 2] * T[v ^ 1] % p
        k *= 2
    return [0 if zs[s] == 0 else I[(n + s) // 2] * T[(n + s) ^ 1] % p for s in range(n)]


@pytest.mark.parametrize("name", list(PRIMES))
@pytest.mark.parametrize("case", ["random", "zero_first", "all_zero"])
def test_tree_inverse_model(name, case):
    """One window's tree: random Z, the P-256 identity's zero Z at entry 0
    (every window of a P-256 table), every Z zero (an identity base)."""
    p = PRIMES[name]
    rs = np.random.RandomState(len(case))
    zs = [int.from_bytes(rs.bytes(40), "little") % (p - 1) + 1 for _ in range(256)]
    if case == "zero_first":
        zs[0] = 0
        zs[77] = p - 1
    elif case == "all_zero":
        zs = [0] * 256
    assert tree_inverse_model(zs, p) == [pow(z, p - 2, p) for z in zs]


def test_entry_rounds_schedule():
    """The index-set rounds as comb8_entries_kernel runs them, on scalars:
    entry 0, entry 1 and m_2 first (the doubling warp); in round r (k =
    2^r) the warps with a team below k add m_k to entries 0..k-1 (passes of
    64 teams; a team past k reads entry k - 1 and stores nothing) while the
    doubling warp writes m_2k; every entry is d times the base, written
    once, from values written in an earlier round."""
    src_rounds, teams, dbl_warp = _const("ROUNDS"), _const("ADD_TEAMS"), _const("DBL_WARP")
    assert (src_rounds, teams, dbl_warp, _const("ENTRY_THREADS")) == (7, 64, 8, 288)
    E, Mk = {0: 0, 1: 1}, {1: 2}
    for r in range(1, src_rounds + 1):
        k = 1 << r
        new_e, new_m = {}, {}
        for warp in range(dbl_warp):
            if warp * 8 >= k:
                continue
            mk = Mk[r]
            for team in range(warp * 8, warp * 8 + 8):
                for j in range((k + teams - 1) // teams):
                    s = team + j * teams
                    live = s < k
                    src = E[s if live else k - 1]
                    if live:
                        assert k + s not in E and k + s not in new_e
                        new_e[k + s] = src + mk
        if r < src_rounds:
            new_m[r + 1] = 2 * Mk[r]
        E.update(new_e)
        Mk.update(new_m)
    assert E == {d: d for d in range(256)}
    assert Mk == {r: 1 << r for r in range(1, 8)}


def _codes() -> list[list[int]]:
    """The operand codes of comb8.cu's wide doublings, in source order
    (wide_weier_dbl's XC, YC, then wide_edw_dbl's), padded to 16 lanes."""
    found = re.findall(r"constexpr uint32_t [XY]C = codes\(([^)]*)\);", COMB8)
    assert len(found) == 4
    return [[int(c) for c in f.split(",")] + [0] * (16 - len(f.split(","))) for f in found]


def _chain_points(g, ops, rs, n):
    """n random points as projective representatives (random Z)."""
    p = ops.f.p
    pts = [g.generator().mul(g.new_scalar(int.from_bytes(rs.bytes(32), "little") % g.order)) for _ in range(n)]
    out = []
    for pt in pts:
        lam = int.from_bytes(rs.bytes(40), "little") % (p - 1) + 1
        out.append([c * lam % p for c in ops._host_coords(pt)])
    return out


def _mul(x: int, y: int, p: int) -> int:
    """fe_mont_mul on unreduced inputs: canonical while x y < p 2^288 (the
    Montgomery domain drops out: every operation is the field's)."""
    assert 0 <= x < 1 << 288 and 0 <= y < 1 << 288 and x * y < p << 288
    return x * y % p


def _lz(v: int, p: int, bound: int) -> int:
    """An unreduced sum (lz_add, lz_sub, lz_shl): nonnegative, below its
    stated bound and below 2^8 p."""
    assert 0 <= v < bound * p and bound <= 256, (v, bound)
    return v


def test_wide_weier_dbl_lanes():
    """wide_weier_dbl on 16 model lanes, its sums unreduced as the kernel
    leaves them (each held to the bound its comment states): the first
    round's nine products from the source's operand codes, b Z carried,
    the second round's six; eight doublings in a chain equal the plain
    doubling's projective coordinates mod p (X, Y below 2p, Z and the
    carry canonical), and the carry stays b Z."""
    ops, p, b = tcurve.p256_ops, p256.p, p256.b
    xc, yc = _codes()[:2]
    for X, Y, Z in _chain_points(p256, ops, np.random.RandomState(3), 3):
        bz = b * Z % p
        P = tf.P256_P.pack([X, Y, Z]).reshape(1, 3, NL)
        for _ in range(8):
            p1 = [_mul([X, Y, Z, bz][xc[q]], [X, Y, Z, Z][yc[q]], p) for q in range(16)]
            xx, yy, zz = p1[0], p1[1], p1[2]
            xy2, xz2, yz2, bzz = 2 * p1[3], 2 * p1[4], 2 * p1[5], p1[6]
            bxz2, bzy2, yy4 = 2 * p1[7], 2 * p1[8], 4 * yy
            w = _lz(3 * _lz(bzz + 2 * p - xz2, p, 3), p, 9)
            zc, xc_ = _lz(yy + 16 * p - w, p, 17), _lz(yy + w, p, 10)
            v = _lz(3 * _lz(_lz(bxz2 + 4 * p - 3 * zz, p, 6) - xx, p, 6), p, 18)
            u = _lz(3 * _lz(xx + p - zz, p, 2), p, 6)
            xs, ys = [xy2, yz2, xc_, u], [zc, v, zc, v]
            p2 = [_mul(xs[q & 3] if q < 4 else (bzy2 if q & 1 else yz2), ys[q & 3] if q < 4 else yy4, p)
                  for q in range(16)]
            X, Y, Z, bz = _lz(p2[0] + p - p2[1], p, 2), _lz(p2[2] + p2[3], p, 2), p2[4], p2[5]
            P = ops.dbl(P)
            assert [X % p, Y % p, Z] == tf.P256_P.unpack(P) and bz == b * Z % p


def test_wide_edw_dbl_lanes():
    """wide_edw_dbl likewise: six products (a X carried), its sums below
    4p, then five products; eight doublings equal the plain HWCD
    doubling's (X, Y, T, Z), canonical, the carry a X."""
    ops, p, a = tcurve.tom_ops, tomEdwards256.p, tomEdwards256.a
    xc, yc = _codes()[2:]
    for X, Y, T, Z in _chain_points(tomEdwards256, ops, np.random.RandomState(4), 3):
        ax = a * X % p
        P = tf.TOM_P.pack([X, Y, T, Z]).reshape(1, 4, NL)
        for _ in range(8):
            p1 = [_mul([X, Y, Z, ax][xc[q]], [X, Y, Z, Z][yc[q]], p) for q in range(16)]
            A, B, C, E, D, aE = p1[0], p1[1], 2 * p1[2], 2 * p1[3], p1[4], 2 * p1[5]
            G = _lz(D + B, p, 2)
            F, H = _lz(G + 2 * p - C, p, 4), _lz(D + p - B, p, 2)
            xs, ys = [E, G, E, F], [F, H, H, G]
            p2 = [_mul(xs[q & 3] if q < 4 else aE, ys[q & 3] if q < 4 else F, p) for q in range(16)]
            X, Y, T, Z, ax = p2[0], p2[1], p2[2], p2[3], p2[4]
            P = ops.dbl(P)
            assert [X, Y, T, Z] == tf.TOM_P.unpack(P) and ax == a * X % p


def _affine(t: torch.Tensor) -> list:
    """A P-256 table [..., 3, 9], projective or affine -> (x, y) per entry,
    None for a zero Z (the identity)."""
    p = p256.p
    out = []
    for X, Y, Z in zip(*[tf.P256_P.unpack(t[..., k, :]) for k in range(3)]):
        out.append(None if Z == 0 else (X * pow(Z, -1, p) % p, Y * pow(Z, -1, p) % p))
    return out


@pytest.mark.parametrize("which", ["identity", "random"])
def test_plain_comb8_vs_jax_extra_bases(which):
    """The plain comb8_bases then comb8_entries (comb_table, comb_table_mixed)
    against the JAX package's comb_table / comb_table_mixed for one base
    that tests/test_torch_params.py does not take: the identity (every
    P-256 Z zero; the Tom-256 table all (0, 1)) or a random multiple of
    the generator."""
    rs = np.random.RandomState(141)
    for g, jg, ops, jops in ((p256, jp256, tcurve.p256_ops, jcurve.p256_ops),
                             (tomEdwards256, jtom, tcurve.tom_ops, jcurve.tom_ops)):
        if which == "identity":
            pt, jpt = g.identity(), jg.identity()
        else:
            k = int.from_bytes(rs.bytes(32), "little") % g.order
            pt, jpt = g.generator().mul(g.new_scalar(k)), jg.generator().mul(jg.new_scalar(k))
        jP = jnp.asarray(jops.pack_points([jpt])[0])
        if g is p256:
            port = tcurve.comb_table(ops.pack_points([pt])[0]).canon
            ref = carry.tables_from_jax({"h_n8": np.asarray(jops.comb_table(jP))})["h_n8"]
            got = _affine(port)
            assert got == _affine(ref)
            assert tf.P256_P.unpack(port[..., 2, :]) == [0 if x is None else 1 for x in got]
        else:
            port = tcurve.comb_table_mixed(ops.pack_points([pt])).canon
            ref = carry.tables_from_jax({"g_t8": np.asarray(jops.comb_table_mixed(jP))})["g_t8"]
            assert torch.equal(port, ref.reshape(port.shape))
