"""The port's field layer (``zkecdsa_tpu_torch.ops.field``) against Python
integers and the JAX package's ``F32Field`` and ``pallas_mul``.

Everything here is modular arithmetic on canonical integers, so every
comparison is exact.  On the CPU the kernel wrappers take their plain
PyTorch versions; tests/test_torch_kernels.py and chip_smoke.py hold the
kernels against those on the card.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zkecdsa_tpu.ops import curve_ops as jcurve
from zkecdsa_tpu.ops import f32field as jf
from zkecdsa_tpu.ops.pallas_field import pallas_mul
from zkecdsa_tpu.protocol.batch_gk import gk_recombine_device
from zkecdsa_tpu_torch.ops import curve_ops as tcurve
from zkecdsa_tpu_torch.ops import field as tf
from zkecdsa_tpu_torch.utils import rng as trng

# One intra-op thread: the suite runs several worker processes on the same
# cores, and an oversubscribed OpenMP pool spins instead of working.
torch.set_num_threads(1)

CSRC = Path(tf.__file__).resolve().parents[1] / "csrc"

# (port field, reference field) pairs, by name
FIELDS = {
    "p256.p": (tf.P256_P, jf.P256_P),
    "p256.n": (tf.P256_N, jf.P256_N),
    "tom.p": (tf.TOM_P, jf.TOM_P),
    "tom.n": (tf.TOM_N, jf.TOM_N),
    "war.p": (tf.WAR_P, jf.WAR_P),
}


@pytest.fixture(autouse=True)
def port_rng():
    with trng.deterministic(0xC0FFEE):
        yield


def _values(p: int, rs: np.random.RandomState, n: int) -> list[int]:
    """Edge values (0, 1, p-1, p-2, values just under 2^bits) then random."""
    bits = p.bit_length()
    edge = [0, 1, p - 1, p - 2, ((1 << bits) - 1) % p, (1 << (bits - 1)) % p, p // 2]
    return edge + [int.from_bytes(rs.bytes(40), "little") % p for _ in range(n - len(edge))]


@pytest.mark.parametrize("name", list(FIELDS))
def test_plain_field_vs_ints_and_f32field(name):
    f, jfield = FIELDS[name]
    p = f.p
    rs = np.random.RandomState(len(name))
    a_i = _values(p, rs, 48)
    b_i = list(reversed(_values(p, rs, 48)))
    a, b = f.pack(a_i), f.pack(b_i)
    assert f.unpack(a) == a_i
    ja, jb = jnp.asarray(jfield.pack(a_i)), jnp.asarray(jfield.pack(b_i))
    cases = {
        "mul": (f.mul(a, b), jfield.mul(ja, jb), [x * y % p for x, y in zip(a_i, b_i)]),
        "add": (f.add(a, b), jfield.add(ja, jb), [(x + y) % p for x, y in zip(a_i, b_i)]),
        "sub": (f.sub(a, b), jfield.sub(ja, jb), [(x - y) % p for x, y in zip(a_i, b_i)]),
        "neg": (f.neg(a), jfield.neg(ja), [-x % p for x in a_i]),
    }
    for op, (got, jgot, want) in cases.items():
        assert got.dtype == torch.int32 and got.shape == a.shape, op
        assert f.unpack(got) == want, op
        assert jfield.unpack_canonical(jfield.canon(jgot)) == want, op
    inv = f.unpack(f.inv(a[:12]))
    assert inv == [pow(x, p - 2, p) for x in a_i[:12]]
    assert jfield.unpack(jfield.inv(ja[:12])) == inv
    assert f.is_zero(a).tolist() == [x == 0 for x in a_i]
    assert f.equal(a, f.pack(a_i)).all()
    assert not f.equal(a, b).any()


@pytest.mark.parametrize("name", list(FIELDS))
def test_mont_forms_round_trip(name):
    """pack_mont writes x * 2^288 mod p and from_mont (plain tensor ops)
    takes it back, edge values included; the JAX package has no
    Montgomery form, so Python integers are the reference."""
    f, _ = FIELDS[name]
    p = f.p
    a_i = _values(p, np.random.RandomState(11 + len(name)), 24)
    m = f.pack_mont(a_i)
    assert f.unpack(m) == [x * (1 << 288) % p for x in a_i]
    assert f.unpack(f.from_mont(m.reshape(2, 12, -1))) == a_i


@pytest.mark.parametrize("name", list(FIELDS))
def test_working_form_chains_stay_exact(name):
    """Long chains of lazy sums and products in the plain working form
    (what the curve formulas do) end on the same canonical integers."""
    f, _ = FIELDS[name]
    p = f.p
    rs = np.random.RandomState(7 + len(name))
    a_i, b_i = _values(p, rs, 32), list(reversed(_values(p, rs, 32)))
    w, v = f.to_work(f.pack(a_i)), f.to_work(f.pack(b_i))
    acc, ref = w, list(a_i)
    for _ in range(12):
        acc = f.wsmall(f.wsub(f.wmul(acc, f.wadd_lazy(w, v)), f.wneg(v)), 3)
        ref = [3 * (r * (x + y) + y) % p for r, x, y in zip(ref, a_i, b_i)]
    assert f.unpack(f.canon(acc)) == ref


@pytest.mark.parametrize("name", ["p256.p", "tom.p"])
def test_field_mul_wrapper_vs_pallas_mul(name):
    """The field_mul wrapper (plain version on CPU tensors) against the
    reference's Pallas kernel in interpret mode, plus the pair form."""
    f, jfield = FIELDS[name]
    p = f.p
    B = 16
    rs = np.random.RandomState(11)
    a_i, b_i = _values(p, rs, B), [int.from_bytes(rs.bytes(40), "little") % p for _ in range(B)]
    got = tf.field_mul(f, f.pack(a_i), f.pack(b_i))
    ref = pallas_mul(jfield, block=B, interpret=True)(
        jnp.asarray(jfield.pack(a_i)), jnp.asarray(jfield.pack(b_i))
    )
    assert f.unpack(got) == jfield.unpack(ref) == [x * y % p for x, y in zip(a_i, b_i)]
    d_i, e_i = b_i[::-1], a_i[::-1]
    pair = tf.field_mul(f, f.pack(a_i), f.pack(b_i), f.pack(d_i), f.pack(e_i))
    assert f.unpack(pair) == [(a * b + d * e) % p for a, b, d, e in zip(a_i, b_i, d_i, e_i)]


@pytest.mark.parametrize(
    "ring,N",
    [pytest.param(8, 2, id="8"), pytest.param(16, 2, id="16")]
    + [pytest.param(ring, N, id=f"n{ring.bit_length() - 1}-N{N}") for ring in (1, 2, 16) for N in (1, 3)],
)
def test_ring_fold_vs_gk_recombine_device(ring, N):
    """The wrapper (the plain version on CPU tensors) and ``ring_fold_plain``
    against the JAX ``gk_recombine_device`` (``_fold_ring``) and Python
    integers, at n = 0 (the values row), 1, 3 and 4 factors."""
    n = ring.bit_length() - 1
    q = tf.TOM_N.p
    rs = np.random.RandomState(ring)
    vals = [int.from_bytes(rs.bytes(32), "little") % q for _ in range(ring)]
    fs = [[int.from_bytes(rs.bytes(32), "little") % q for _ in range(n)] for _ in range(N)]
    xs = [int.from_bytes(rs.bytes(32), "little") % q for _ in range(N)]
    xf = [[(xs[i] - fs[i][j]) % q for j in range(n)] for i in range(N)]
    flat = lambda rows: [v for r in rows for v in r]  # noqa: E731
    args = (
        tf.TOM_N.pack(vals),
        tf.TOM_N.pack(flat(fs)).reshape(N, n, tf.NLIMBS),
        tf.TOM_N.pack(flat(xf)).reshape(N, n, tf.NLIMBS),
    )
    got = tf.ring_fold(*args)
    assert torch.equal(got, tf.ring_fold_plain(*args))
    fo = jf.TOM_N
    L = fo.pack([0]).shape[-1]
    ref = gk_recombine_device(
        jnp.asarray(fo.pack(flat(fs))).reshape(N, n, L),
        jnp.asarray(fo.pack(flat(xf))).reshape(N, n, L),
        jnp.asarray(fo.pack(vals)),
    )
    want = []
    for i in range(N):
        tot = 0
        for k, v in enumerate(vals):
            for j in range(n):
                v = v * (fs[i][j] if (k >> j) & 1 else xf[i][j]) % q
            tot += v
        want.append(tot % q)
    assert tf.TOM_N.unpack(got) == fo.unpack_canonical(ref) == want


def test_digit_helpers_match_reference():
    rs = np.random.RandomState(5)
    scs = [0, 1, (1 << 256) - 1] + [int.from_bytes(rs.bytes(32), "big") for _ in range(13)]
    np.testing.assert_array_equal(tcurve.nibble_digits(scs), jcurve.nibble_digits(scs))
    np.testing.assert_array_equal(tcurve.byte_digits(scs), jcurve.byte_digits(scs))
    # canonical limbs are their own LSB-first byte digits
    f = tf.TOM_N
    vals = [s % f.p for s in scs]
    np.testing.assert_array_equal(
        tf.bytes_le(f.pack(vals)).numpy().astype(np.int32), jcurve.byte_digits(vals)
    )


def _hex_rows(text: str) -> list[list[int]]:
    return [
        [int(h, 16) for h in re.findall(r"0x([0-9a-f]{8})u", row)]
        for row in re.findall(r"\{(0x[0-9a-fu, x]+)\}", text)
    ]


def test_kernel_constants_match_python():
    """The moduli and curve coefficients compiled into csrc/*.cuh."""
    R = 1 << 288
    limbs = lambda x: [(x >> (32 * i)) & 0xFFFFFFFF for i in range(tf.NLIMBS)]  # noqa: E731
    field_h = (CSRC / "field.cuh").read_text()
    mods = field_h[field_h.index("ZK_MODS[5]") :]
    rows = _hex_rows(mods)
    pinvs = [int(h, 16) for h in re.findall(r"\},\s*0x([0-9a-f]{8})u\}", mods)]
    by_id = sorted((f.mod_id, f) for f, _ in FIELDS.values())
    assert [i for i, _ in by_id] == list(range(5))
    for (mod_id, f), pinv in zip(by_id, pinvs):
        assert re.search(rf"#define ZK_{f.name.replace('.', '_').upper()} {mod_id}\b", field_h)
        p = f.p
        assert rows[3 * mod_id] == limbs(p)
        assert rows[3 * mod_id + 1] == limbs(R * R % p)
        assert rows[3 * mod_id + 2] == limbs(R % p)
        assert pinv == (-pow(p, -1, 1 << 32)) % (1 << 32)
    curve_h = (CSRC / "curve.cuh").read_text()
    coef = _hex_rows(curve_h[curve_h.index("ZK_COEF[4]") :])[:4]
    p256, war, tom = tcurve.p256_ops, tcurve.war_ops, tcurve.tom_ops
    want = [
        (p256.b, p256.f.p), (war.b, war.f.p), (tom.a, tom.f.p), (tom.d, tom.f.p),
    ]
    assert coef == [limbs(v * R % p) for v, p in want]
    for ops, cid in ((p256, "P256"), (war, "WAR"), (tom, "TOM")):
        assert re.search(rf"#define ZK_CURVE_{cid} {ops.curve_id}\b", curve_h)



def _chord_inputs(rs, K):
    """K phase-B rows as Python ints: T1 as projective P-256 points (each
    scaled by a random lambda) and the 13 other inputs; row 1 has T1 the
    identity (Z = 0), row 2 pkx = t1x (i7 = 0), row 3 both (pkx = 0)."""
    p = tf.TOM_N.p
    pts = [tcurve.p256_ops.group.generator().mul(tcurve.p256_ops.group.new_scalar(
        int.from_bytes(rs.bytes(32), "little") % tcurve.p256_ops.group.order)) for _ in range(K)]
    pts[1] = pts[3] = tcurve.p256_ops.group.identity()
    t1 = []
    for pt in pts:
        lam = int.from_bytes(rs.bytes(40), "little") % (p - 1) + 1
        t1.append([c * lam % p for c in tcurve.p256_ops._host_coords(pt)])
    rows = [[int.from_bytes(rs.bytes(40), "little") % p for _ in range(13)] for _ in range(K)]
    rows[2][0] = t1[2][0] * pow(t1[2][2], -1, p) % p  # pkx == t1x: a zero to invert
    rows[3][0] = 0
    return t1, rows


def test_chord_vs_reference_field_pass():
    """The fused chord pass (CPU: the plain version) against the reference's
    phase B on F32Field: ``nist_affine_std`` of T1 (protocol/batch.py:463),
    then the field pass (:464-493) with its batch_inv tree, which maps a
    zero to zero; rows with T1 the identity, with i7 = 0, and both."""
    from zkecdsa_tpu.protocol.batch import nist_affine_std

    rs = np.random.RandomState(17)
    K = 6
    t1, rows = _chord_inputs(rs, K)
    T1 = tf.TOM_N.pack(sum(t1, [])).reshape(K, 3, -1)
    got = tf.TOM_N.unpack(tcurve.chord(T1, tf.TOM_N.pack(sum(rows, [])).reshape(K, 13, -1)))
    fo = jf.TOM_N
    jT1 = jnp.asarray(fo.pack(sum(t1, [])).reshape(K, 3, -1))
    t1x, t1y, inf = nist_affine_std(jT1)
    assert np.asarray(inf).tolist() == [False, True, False, True, False, False]
    pkx, pky, txv, pky_r, txr, cb0, cb1, cb2, cb3, *kx = (
        jnp.asarray(fo.pack([r[s] for r in rows])) for s in range(13)
    )
    i7 = fo.sub(pkx, t1x)
    i8 = fo.batch_inv(i7)
    i9 = fo.sub(pky, t1y)
    i10 = fo.mul(i8, i9)
    i12 = fo.sub(t1x, txv)
    ys, xs = [i8, i9, i10, i12], [i7, i8, i10, i10]
    rb = [cb2, fo.sub(pky_r, cb1), cb3, fo.sub(cb0, txr)]
    ref = (
        [t1x, t1y, i7, i8, i9, i10, fo.mul(i10, i10), i12, fo.mul(i10, i12)]
        + [fo.mul(x, y) for x, y in zip(xs, ys)] + [fo.mul(k, y) for k, y in zip(kx, ys)]
        + [fo.mul(x, r) for x, r in zip(xs, rb)] + [fo.mul(k, r) for k, r in zip(kx, rb)]
    )
    ref_ints = [fo.unpack_canonical(fo.canon(v)) for v in ref]  # 25 x [K]
    assert len(ref_ints) == len(tcurve.CHORD_OUT)
    for k in range(K):
        assert got[25 * k : 25 * k + 25] == [col[k] for col in ref_ints], k
    p = fo.p
    for k, name in ((1, "Z = 0"), (2, "i7 = 0"), (3, "both")):
        row = got[25 * k : 25 * k + 25]
        i7_k = (rows[k][0] - row[0]) % p
        assert row[2:4] == [i7_k, pow(i7_k, p - 2, p)], name
    assert got[25 + 0 : 25 + 2] == [0, 0] and got[50 + 2 : 50 + 4] == [0, 0] and got[75 : 79] == [0] * 4


def test_point_bytes_and_challenges_vs_reference():
    """be_bytes/point_bytes/challenge_rows on canonical limbs against the
    reference's on F32Field digits, with a (0, 0) identity row, and the
    challenges against host hash_points on the other rows."""
    from zkecdsa_tpu.protocol import fiat_shamir as jfs
    from zkecdsa_tpu_torch.curves.group import hash_points
    from zkecdsa_tpu_torch.curves.instances import p256, tomEdwards256
    from zkecdsa_tpu_torch.protocol import fiat_shamir as tfs

    rs = np.random.RandomState(19)
    for g, (f, jfield), nb in ((tomEdwards256, FIELDS["tom.p"], 33), (p256, FIELDS["p256.p"], 32)):
        pts = [g.generator().mul(g.new_scalar(int.from_bytes(rs.bytes(32), "big") % g.order)) for _ in range(4)]
        aff = [pt.to_affine() for pt in pts] + [(0, 0)]
        xs, ys = [a[0] for a in aff], [a[1] for a in aff]
        got = tfs.point_bytes(f.pack(xs), f.pack(ys), nb)
        ref = jfs.point_bytes(jfield, jfield.pack(xs), jfield.pack(ys), nb)
        np.testing.assert_array_equal(got, ref)
        assert got[0].tobytes() == pts[0].to_bytes()
        np.testing.assert_array_equal(tfs.be_bytes(f.pack(xs), nb), jfs.be_bytes(jfield, jfield.pack(xs), nb))
        rows = got.reshape(1, -1)
        assert tfs.challenge_rows([rows[:, :100], rows[:, 100:]]) == jfs.challenge_rows([rows])
        assert tfs.challenge_rows([got[:4].reshape(1, -1)]) == [hash_points(pts)]


def test_gk_dvalues_device_vs_reference():
    """The port's d-values (one ring_fold over N*n rows, host factors)
    against the reference's scan over the evaluation points, N=2, ring 16."""
    from zkecdsa_tpu.protocol.batch_gk import gk_dvalues_device as jdvalues
    from zkecdsa_tpu_torch.protocol.batch_gk import gk_dvalues_device

    N, n = 2, 4
    q = tf.TOM_N.p
    rs = np.random.RandomState(23)
    values = [int.from_bytes(rs.bytes(32), "little") % q for _ in range(1 << n)]
    which = [5, 12]
    eli = [[(w >> j) & 1 for j in range(n)] for w in which]
    ai = [[int.from_bytes(rs.bytes(32), "little") % q for _ in range(n)] for _ in range(N)]
    got = gk_dvalues_device(eli, ai, values, [values[w] for w in which], "cpu")
    fo = jf.TOM_N
    ref = jdvalues(
        jnp.asarray(np.array(eli, np.int32)),
        jnp.asarray(fo.pack(sum(ai, []))).reshape(N, n, -1),
        jnp.asarray(fo.pack(values)),
        jnp.asarray(fo.pack([values[w] for w in which])),
    )
    assert sum(got, []) == fo.unpack_canonical(ref)


def _gk_ints(proof) -> list[int]:
    pts = [c for arr in (proof.cl, proof.ca, proof.cb, proof.cd) for pt in arr for c in pt.to_affine()]
    return pts + [s.k for arr in (proof.f, proof.za, proof.zb) for s in arr] + [proof.zd.k]


@pytest.mark.parametrize("ring_len,which", [(16, (3, 14)), (1, (0, 0))])
def test_batch_prove_membership_vs_reference(ring_len, which):
    """The port's batched GK prover (device d-values and commitments, CPU
    tensors) against the reference's (device d-values, host commitments)
    on the same tapes, N=2: ring 16, and a ring of one key (no bits)."""
    from zkecdsa_tpu.protocol.batch_gk import batch_prove_membership as jprove_membership
    from zkecdsa_tpu.serde import write_json as jwrite_json
    from zkecdsa_tpu.utils import rng as jrng
    from zkecdsa_tpu.zkp_attest_list import SystemParametersList as JParams
    from zkecdsa_tpu.zkp_attest_list import generate_params_list as jgenerate_params
    from zkecdsa_tpu_torch import carry
    from zkecdsa_tpu_torch.commit.pedersen import Commitment
    from zkecdsa_tpu_torch.curves.edwards import TEdwardsPoint
    from zkecdsa_tpu_torch.curves.instances import tomEdwards256
    from zkecdsa_tpu_torch.protocol.batch import DeviceParams
    from zkecdsa_tpu_torch.protocol.batch_gk import batch_prove_membership

    with jrng.deterministic(29):
        jparams = jgenerate_params()
        ring = [int.from_bytes(jrng.random_bytes(32), "big") for _ in range(ring_len)]
        jcoms = [jparams.proof_group.commit(ring[w]) for w in which]
    tparams = carry.params_from_jax(jwrite_json(JParams, jparams))
    tcoms = [
        Commitment(TEdwardsPoint(tomEdwards256, *c.p.to_affine()), tomEdwards256.new_scalar(c.r.k))
        for c in jcoms
    ]
    ref = jprove_membership(
        jparams.proof_group, jcoms, list(which), ring, [jrng.DeterministicSource(s) for s in (7, 8)]
    )
    got = batch_prove_membership(
        tparams.proof_group, tcoms, list(which), ring, [trng.DeterministicSource(s) for s in (7, 8)],
        dev=DeviceParams(tparams, "cpu"),
    )
    assert [_gk_ints(p) for p in got] == [_gk_ints(p) for p in ref]
