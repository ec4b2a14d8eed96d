"""The P-256 prime's Solinas arithmetic of the port's field kernels
(``csrc/field.cuh``: ``p256_wide_mul``, ``p256_reduce``, ``p256_fold``;
``csrc/field.cu``: ``SolinasOp``'s pair form, ``P256Acc``, ``field_sum``'s
unreduced sums), modelled step by step with Python integers, and the
chain form of ``field_mul`` against the JAX package's chain.

The kernels do not run on the CPU.  The models read what can drift from
the source (the reduction's chains with their word indices, the 5p
words, the fold's positions) and take every step the kernel
takes, asserting each step's bound; the ``cuda`` tests on the card
(tests/test_torch_kernels.py) hold the kernels themselves, on the same
edge operands (tests/torch_field_edges.py).
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_field_edges import P, SOLINAS_EDGE

from zkecdsa_tpu.ops import f32field as jf
from zkecdsa_tpu_torch.ops import field as tf

# One intra-op thread: the suite runs several worker processes on the same
# cores, and an oversubscribed OpenMP pool spins instead of working.
torch.set_num_threads(1)

FIELD_H = (Path(tf.__file__).resolve().parents[1] / "csrc" / "field.cuh").read_text()
W32 = (1 << 32) - 1
R288 = 1 << 288
C256 = (1 << 256) - P  # 2^256 mod p = 2^224 - 2^192 - 2^96 + 1

# FIPS 186-4 D.2.3: the nine word permutations of c0..c15, LSB first
# (None: a zero word), and the sign each enters the sum with (s2, s3
# twice)
FIPS = {
    "s1": [0, 1, 2, 3, 4, 5, 6, 7],
    "s2": [None, None, None, 11, 12, 13, 14, 15],
    "s3": [None, None, None, 12, 13, 14, 15, None],
    "s4": [8, 9, 10, None, None, None, 14, 15],
    "s5": [9, 10, 11, 13, 14, 15, 13, 8],
    "s6": [11, 12, 13, None, None, None, 8, 10],
    "s7": [12, 13, 14, 15, None, None, 9, 11],
    "s8": [13, 14, 15, 8, 9, 10, None, 12],
    "s9": [14, 15, None, 9, 10, 11, None, 13],
}
FIPS_SUM = ["s1", "s2", "s2", "s3", "s3", "s4", "s5", "-s6", "-s7", "-s8", "-s9"]


def _function(name: str) -> str:
    """The body of the device function ``name`` in field.cuh."""
    start = FIELD_H.index(f"void {name}(")
    end = FIELD_H.index("\n}\n", start)
    return FIELD_H[start:end]


def _words(x: int, n: int) -> list[int]:
    return [(x >> (32 * i)) & W32 for i in range(n)]


def _val(words) -> int:
    return sum(w << (32 * i) for i, w in enumerate(words))


def _arg(text: str):
    """One argument of a p256_add8/sub8 call: a product word c[i] -> i,
    a zero -> None."""
    text = text.strip()
    if text == "0u":
        return None
    return int(re.fullmatch(r"c\[(\d+)\]", text).group(1))


def _reduce_source():
    """p256_reduce as it stands: its chains [(sign, word indices)] after
    s1, the 5p words of its immediate chain, and the fold's (adds, subs)
    word positions of h."""
    body = _function("p256_reduce")
    chains = [(1 if op == "add" else -1, [_arg(a) for a in args.split(",")])
              for op, args in re.findall(r"p256_(add|sub)8\(t, ([^;]*)\);", body)]
    s1 = re.search(r"uint32_t t\[9\] = \{([^}]*)\}", body).group(1).split(",")
    assert [_arg(a) for a in s1] == list(range(8)) + [None]
    five_p = [int(h, 16) for _, h in re.findall(r"%(\d), %\1, (0x[0-9a-f]{8})", body)]
    fold = _function("p256_fold")
    adds = [int(i) for i in re.findall(r"add(?:c)?\.cc\.u32 %(\d), %\1, %9", fold)]
    subs = [int(i) for i in re.findall(r"sub(?:c)?\.cc\.u32 %(\d), %\1, %9", fold)]
    return chains, five_p, (adds, subs)


CHAINS, FIVE_P, FOLD = _reduce_source()


def _fold(t: int) -> int:
    """p256_fold: t[0..7] + h (sum of 2^(32 i) at the add positions less
    those at the sub positions), h = t's top word; the carry chains run
    mod 2^288."""
    h = t >> 256
    adds, subs = FOLD
    return (t % (1 << 256) + h * (sum(1 << (32 * i) for i in adds) - sum(1 << (32 * i) for i in subs))) % R288


def _reduce_once(t: int) -> int:
    """fe_reduce_once: t - p if t >= p else t, for t < 2p (a masked
    select of the difference's borrow)."""
    assert 0 <= t < 2 * P
    d = (t - P) % (1 << 320)  # nine limbs and the hi word
    return t if d >> 319 else d


def model_wide_mul(a: int, b: int) -> list[int]:
    """p256_wide_mul: operand scanning, 64-bit accumulators, 16 words."""
    A, B = _words(a, 8), _words(b, 8)
    c = [0] * 16
    for i in range(8):
        t = 0
        for j in range(8):
            t += A[j] * B[i] + c[i + j]
            assert t < 1 << 64
            c[i + j] = t & W32
            t >>= 32
        c[i + 8] = t
    return c


def model_reduce(c: list[int]) -> tuple[int, dict]:
    """p256_reduce on the 16 words c: the value and what each step did
    (the signed top word before the 5p, the top word h after it, the
    fold's carry, whether the subtraction took p)."""
    t = _val(c[:8])
    exact = t
    for sign, idx in CHAINS:
        s = _val([0 if i is None else c[i] for i in idx])
        t = (t + sign * s) % R288
        exact += sign * s
    signed_top = exact >> 256  # Python's floor: the signed top word
    t = (t + _val(FIVE_P)) % R288
    exact += _val(FIVE_P)
    assert t == exact, "the chains wrapped: the sum left [0, 2^288)"
    h = t >> 256
    assert h <= 11
    t = _fold(t)
    assert t < 2 * P
    r = _reduce_once(t)
    return r, dict(signed_top=signed_top, h=h, carry=t >> 256, subtracted=r != t)


def model_mul(a: int, b: int) -> tuple[int, dict]:
    c = model_wide_mul(a, b)
    assert _val(c) == a * b
    return model_reduce(c)


def model_mul2(a: int, b: int, d: int, e: int) -> int:
    """SolinasOp::mul2: each product reduced, then fe_add (a sum below 2p,
    one masked subtraction)."""
    return _reduce_once(model_mul(a, b)[0] + model_mul(d, e)[0])


def test_reduce_source_is_fips():
    """The kernel's chains are FIPS 186-4's sum, word for word; its
    constant is 5p; its fold adds h at words 0 and 7 and subtracts it at
    words 3 and 6 (h 2^256 mod p)."""
    def key(chain):
        return chain[0], [-1 if i is None else i for i in chain[1]]

    want = [(-1 if s[0] == "-" else 1, FIPS[s.lstrip("-")]) for s in FIPS_SUM[1:]]
    assert sorted(CHAINS, key=key) == sorted(want, key=key)
    assert FIVE_P == _words(5 * P, 9)
    adds, subs = FOLD
    assert (sorted(adds), sorted(subs)) == ([0, 7], [3, 6])
    assert sum(1 << (32 * i) for i in adds) - sum(1 << (32 * i) for i in subs) == C256


def test_solinas_product_edges():
    """The edge pairs against a*b mod p, and what they exercise: the top
    word h through 0..8, its signed form through -4..3, the fold's carry
    0 and 1, the subtraction taken and not."""
    seen = {"h": set(), "signed_top": set(), "carry": set(), "subtracted": set()}
    for a, b in SOLINAS_EDGE:
        r, steps = model_mul(a, b)
        assert r == a * b % P, (hex(a), hex(b))
        for key in seen:
            seen[key].add(steps[key])
    assert seen["h"] == set(range(9))
    assert seen["signed_top"] == set(range(-4, 4))
    assert seen["carry"] == {0, 1} and seen["subtracted"] == {False, True}
    # (p-1)^2, and 2^256 - 1 - p squared, among them
    assert model_mul(P - 1, P - 1)[0] == 1
    assert model_mul((1 << 256) - 1 - P, (1 << 256) - 1 - P)[0] == ((1 << 256) - 1 - P) ** 2 % P


@pytest.mark.parametrize("seed", range(4))
def test_solinas_product_random(seed):
    """500 numpy-seeded pairs a case (2,000 in all) against a*b mod p;
    the top word stays within the bound the fold needs."""
    rs = np.random.RandomState(100 + seed)
    for _ in range(500):
        a, b = (int.from_bytes(rs.bytes(40), "little") % P for _ in range(2))
        r, steps = model_mul(a, b)
        assert r == a * b % P
        assert -4 <= steps["signed_top"] <= 6 and 0 <= steps["h"] <= 11


def test_solinas_reduce_any_512_bits():
    """The reduction holds for any 512-bit input, not only products below
    p^2: all-zero, all-ones and one-word inputs, and random words."""
    rs = np.random.RandomState(9)
    inputs = [0, (1 << 512) - 1] + [W32 << (32 * i) for i in range(16)]
    inputs += [int.from_bytes(rs.bytes(64), "little") for _ in range(200)]
    for x in inputs:
        r, steps = model_reduce(_words(x, 16))
        assert r == x % P
        assert -4 <= steps["signed_top"] <= 6


def test_solinas_pair_form():
    """SolinasOp's pair form against (a*b + d*e) mod p: the edge pairs two
    by two, random operands, and (p-1)^2 + (p-1)^2."""
    rs = np.random.RandomState(10)
    quads = [(a, b, d, e) for (a, b), (d, e) in zip(SOLINAS_EDGE, SOLINAS_EDGE[1:] + SOLINAS_EDGE[:1])]
    quads += [tuple(int.from_bytes(rs.bytes(40), "little") % P for _ in range(4)) for _ in range(300)]
    quads.append((P - 1,) * 4)
    for a, b, d, e in quads:
        assert model_mul2(a, b, d, e) == (a * b + d * e) % P


def _sum_model(values: list[int], lanes: int) -> int:
    """field_sum on the P-256 prime (P256Acc): each lane sums a strided
    share unreduced in 9 words (8 and a carry word), the lanes' sums are
    added word by word as the shuffle tree pairs them, then two folds and
    one masked subtraction."""
    parts = [sum(values[i::lanes]) for i in range(lanes)]
    while len(parts) > 1:  # __shfl_down_sync pairs l with l + half
        half = len(parts) // 2
        parts = [parts[i] + parts[i + half] for i in range(half)]
    t = parts[0]
    assert t < R288  # nine words hold up to 2^32 terms below p
    t = _fold(t)
    assert t < 1 << 257
    t = _fold(t)
    assert t < 1 << 256
    return _reduce_once(t)


@pytest.mark.parametrize("D,lanes", [(0, 1), (2, 1), (8, 1), (2048, 256), (300, 64)])
def test_p256_sum_model(D, lanes):
    """The unreduced sums and their one reduction against sum mod p, on
    p-1 D times (the carry word's largest values), on random values, and
    on 2^32 - 1 terms of p-1 (the most nine words hold)."""
    rs = np.random.RandomState(D)
    rand = [int.from_bytes(rs.bytes(40), "little") % P for _ in range(D)]
    for vals in ([P - 1] * D, rand):
        assert _sum_model(vals, lanes) == sum(vals) % P
    top = (W32 * (P - 1)) % R288
    assert top == W32 * (P - 1)
    t = _fold(_fold(top))
    assert _reduce_once(t) == W32 * (P - 1) % P


@pytest.mark.parametrize("n", [0, 1, 4])
def test_chain_plain_vs_jax_chain(n):
    """field_mul_chain's plain version (the wrapper on CPU tensors) against
    the JAX package's chain in sharded_gk_total (zkecdsa_tpu/parallel/
    mesh.py:122-125: fo.mul over the factors, then by the values, on
    TOM_N of f32field), R = 16, exact canonical integers."""
    q = tf.TOM_N.p
    R = 16
    rs = np.random.RandomState(20 + n)
    v_i = [int.from_bytes(rs.bytes(40), "little") % q for _ in range(R)]
    f_i = [int.from_bytes(rs.bytes(40), "little") % q for _ in range(R * n)]
    f_i[:2] = [0, q - 1][: len(f_i[:2])]
    got = tf.field_mul_chain(tf.TOM_N, tf.TOM_N.pack(v_i), tf.TOM_N.pack(f_i).reshape(R, n, tf.NLIMBS))
    want = []
    for r in range(R):
        acc = v_i[r]
        for j in range(n):
            acc = acc * f_i[r * n + j] % q
        want.append(acc)
    assert tf.TOM_N.unpack(got) == want
    if n:
        fo = jf.TOM_N
        factors = jnp.asarray(fo.pack(f_i)).reshape(R, n, -1)
        prod = factors[:, 0]
        for j in range(1, n):
            prod = fo.mul(prod, factors[:, j])
        terms = fo.mul(jnp.asarray(fo.pack(v_i)), prod)
        assert fo.unpack_canonical(fo.canon(terms)) == want
