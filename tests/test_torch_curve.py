"""The port's curve layer (``zkecdsa_tpu_torch.ops.curve_ops``) against the
JAX package's ``p256_ops``/``tom_ops``, its ``pallas_ec_add`` (interpret
mode) and the host curves.

The port's plain versions evaluate the reference's formulas operation for
operation, so wherever both take the same sequence of point operations the
canonical projective coordinates are the same integers; the comparisons
are exact.  tests/test_torch_kernels.py and chip_smoke.py hold the kernels
against the plain versions on the card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zkecdsa_tpu.curves.instances import tomEdwards256 as jtom
from zkecdsa_tpu.ops import curve_ops as jcurve
from zkecdsa_tpu.ops.pallas_field import pallas_ec_add
from zkecdsa_tpu.protocol.batch import device_params_for as jax_device_params_for
from zkecdsa_tpu.serde import write_json as jax_write_json
from zkecdsa_tpu.utils import rng as jrng
from zkecdsa_tpu.zkp_attest_list import SystemParametersList as JaxParams
from zkecdsa_tpu.zkp_attest_list import generate_params_list as jax_generate_params
from zkecdsa_tpu_torch import carry
from zkecdsa_tpu_torch.curves.instances import p256, tomEdwards256
from zkecdsa_tpu_torch.curves.multimult import MultiMult
from zkecdsa_tpu_torch.ops import curve_ops as tcurve
from zkecdsa_tpu_torch.protocol.batch import DeviceParams
from zkecdsa_tpu_torch.utils import rng as trng

# One intra-op thread: the suite runs several worker processes on the same
# cores, and an oversubscribed OpenMP pool spins instead of working.
torch.set_num_threads(1)

# curve name -> (port ops, reference ops, port host group)
CURVES = {
    "p256": (tcurve.p256_ops, jcurve.p256_ops, p256),
    "tomEdwards256": (tcurve.tom_ops, jcurve.tom_ops, tomEdwards256),
}


@pytest.fixture(autouse=True)
def port_rng():
    with trng.deterministic(0xC0FFEE):
        yield


@pytest.fixture(scope="module")
def params():
    """One parameter set, made by the reference and carried across on the
    wire: (reference params, port params, reference tables, port tables)."""
    with jrng.deterministic(21):
        jparams = jax_generate_params()
    tparams = carry.params_from_jax(jax_write_json(JaxParams, jparams))
    jtabs = jax_device_params_for(jparams).tabs()
    ttabs = DeviceParams(tparams, "cpu").tabs()
    return jparams, tparams, jtabs, ttabs


def _points(g, rs, n):
    G = g.generator()
    return [G.mul(g.new_scalar(int.from_bytes(rs.bytes(32), "little") % g.order)) for _ in range(n)]


def _edge_pairs(g, rs):
    """Random pairs, then identity + P, P + P, P + (-P), identity + identity."""
    P = _points(g, rs, 5)
    Q = _points(g, rs, 5)
    ident = g.identity()
    return P + [ident, P[0], P[1], ident], Q + [P[2], P[0], P[1].neg(), ident]


def _coords(jops, arr) -> list[list[int]]:
    """Reference digit array [B, C, L] -> per-point canonical coordinates."""
    a = np.asarray(arr)
    cols = [jops.f.unpack(a[:, k]) for k in range(a.shape[1])]
    return [list(c) for c in zip(*cols)]


def _tcoords(tops, t) -> list[list[int]]:
    cols = [tops.f.unpack(t[:, k]) for k in range(t.shape[1])]
    return [list(c) for c in zip(*cols)]


@pytest.mark.parametrize("name", list(CURVES))
def test_group_law_vs_reference(name):
    tops, jops, g = CURVES[name]
    rs = np.random.RandomState(31 + len(name))
    P_h, Q_h = _edge_pairs(g, rs)
    P, Q = tops.pack_points(P_h), tops.pack_points(Q_h)
    jP, jQ = jnp.asarray(jops.pack_points(P_h)), jnp.asarray(jops.pack_points(Q_h))
    B = P.shape[0]

    got = tcurve.ec_add(tops, P, Q)  # CPU tensor: the plain version
    want = _coords(jops, jops.add(jP, jQ))
    assert _tcoords(tops, got) == want
    assert _coords(jops, pallas_ec_add(jops, block=B, interpret=True)(jP, jQ)) == want
    for r, p, q in zip(tops.unpack_points(got), P_h, Q_h):
        assert r.eq(p.add(q))
    assert _tcoords(tops, tops.dbl(P)) == _coords(jops, jops.dbl(jP))

    x, y, inf = tcurve.to_affine(tops, got)
    jx, jy, jinf = jops.to_affine(jops.add(jP, jQ))
    assert tops.f.unpack(x) == jops.f.unpack(jx)
    assert tops.f.unpack(y) == jops.f.unpack(jy)
    assert inf.tolist() == np.asarray(jinf).tolist()
    for i, pt in enumerate(tops.unpack_points(got)):
        aff = pt.to_affine()
        assert (aff is None) == bool(inf[i])
        if aff is not None:
            assert (tops.f.unpack(x[i : i + 1])[0], tops.f.unpack(y[i : i + 1])[0]) == aff
    ident = tops.is_identity(got).tolist()
    assert ident == np.asarray(jops.is_identity(jops.add(jP, jQ))).tolist()
    assert ident[-2:] == [True, True]  # P + (-P), identity + identity
    assert tcurve.sum_reduce(tops, got[:0]).tolist() == tops.identity().tolist()


@pytest.mark.parametrize("where", ["first", "middle", "last", "all"])
@pytest.mark.parametrize("name", list(CURVES))
def test_to_affine_vs_reference(name, where):
    """The plain to_affine (one batch inversion over the batch) against the
    reference's ``CurveOps.to_affine`` (``batch_inv``) and the host
    points, with the identity first, in the middle, last, or everywhere:
    its Z is zero on P-256 (flagged, (0, 0)) and one on Tom-256."""
    tops, jops, g = CURVES[name]
    rs = np.random.RandomState(51 + len(name))
    pts = _points(g, rs, 9)
    at = {"first": [0], "middle": [4], "last": [8], "all": range(9)}[where]
    for i in at:
        pts[i] = g.identity()
    P = tops.pack_points(pts).reshape(3, 3, tops.NCOORD, -1)
    x, y, inf = tcurve.to_affine(tops, P)  # CPU tensor: the plain version
    assert x.shape == y.shape == (3, 3, 9) and inf.shape == (3, 3)
    jx, jy, jinf = jops.to_affine(jnp.asarray(jops.pack_points(pts)))
    assert tops.f.unpack(x) == jops.f.unpack(jx)
    assert tops.f.unpack(y) == jops.f.unpack(jy)
    assert inf.reshape(-1).tolist() == np.asarray(jinf).tolist()
    for i, pt in enumerate(pts):
        aff = pt.to_affine()
        assert (aff is None) == bool(inf.reshape(-1)[i])
        want = (0, 0) if aff is None else aff
        assert (tops.f.unpack(x.reshape(-1, 9)[i : i + 1])[0], tops.f.unpack(y.reshape(-1, 9)[i : i + 1])[0]) == want


@pytest.mark.parametrize("name", list(CURVES))
def test_straus_msm_vs_msm_shared_and_host(name):
    tops, jops, g = CURVES[name]
    rs = np.random.RandomState(41)
    R, T = 2, 5
    pts = [_points(g, rs, T) for _ in range(R)]
    scs = [[int.from_bytes(rs.bytes(32), "little") % g.order for _ in range(T)] for _ in range(R)]
    scs[1][0] = 0  # a zero scalar: an identity term
    arr = torch.stack([tops.pack_points(r) for r in pts])
    dig = torch.from_numpy(tcurve.nibble_digits(sum(scs, [])).astype(np.uint8)).reshape(R, T, 64)
    got = tcurve.straus_msm(tops, arr, dig)  # CPU tensor: ops.msm_shared
    ref = jops.msm_shared(
        jnp.asarray(np.stack([jops.pack_points(r) for r in pts])),
        jnp.asarray(jcurve.nibble_digits(sum(scs, [])).reshape(R, T, 64)),
    )
    assert _tcoords(tops, got) == _coords(jops, ref)
    for r in range(R):
        multi = MultiMult(g)
        for p, s in zip(pts[r], scs[r]):
            multi.insert(p, g.new_scalar(s))
        assert tops.unpack_points(got[r : r + 1])[0].eq(multi.evaluate())


def test_comb_mixed_vs_double_mul_comb_mixed(params):
    _, _, jtabs, ttabs = params
    rs = np.random.RandomState(51)
    B = 6
    v = [int.from_bytes(rs.bytes(32), "little") % jtom.order for _ in range(B)]
    r = [int.from_bytes(rs.bytes(32), "little") % jtom.order for _ in range(B)]
    v[0], r[0] = 0, 0  # zero digits: the identity
    d8 = torch.from_numpy(
        np.concatenate([tcurve.byte_digits(v), tcurve.byte_digits(r)], axis=1).astype(np.uint8)
    )
    got = tcurve.comb_mixed(ttabs["gh_t8"], d8)
    ref = jcurve.tom_ops.double_mul_comb_mixed(
        jtabs["g_t8"], jnp.asarray(jcurve.byte_digits(v)),
        jtabs["h_t8"], jnp.asarray(jcurve.byte_digits(r)),
    )
    assert _tcoords(tcurve.tom_ops, got) == _coords(jcurve.tom_ops, ref)
    assert bool(tcurve.tom_ops.is_identity(got[0]))
    add_mixed = tcurve.tom_ops.add_mixed(got, ttabs["g_t8"][3, 7].expand(B, 5, -1))
    ref_mixed = jcurve.tom_ops.add_mixed(ref, jtabs["g_t8"][3, 7])
    assert _tcoords(tcurve.tom_ops, add_mixed) == _coords(jcurve.tom_ops, ref_mixed)


def test_tables_carry_across(params):
    """The reference's device tables, carried to canonical limbs, equal the
    tables the port builds with its host arithmetic.  The P-256 comb table
    of h is projective in the reference and affine (Z = 1) in the port:
    it is compared on affine points, its identity entries included."""
    jparams, tparams, jtabs, ttabs = params
    carried = carry.tables_from_jax({k: np.asarray(v) for k, v in jtabs.items()})
    # every table tensor; not the holders of both forms, gh_t8 (its
    # canonical halves are g_t8 and h_t8, test_mixed_comb_forms) and
    # comb_h_n8 (its canonical form is h_n8, test_weier_comb_forms)
    tensors = {k: t for k, t in ttabs.items() if k not in ("gh_t8", "comb_h_n8")}
    assert set(tensors) <= set(carried)
    for key, t in tensors.items():
        assert carried[key].dtype == torch.int32
        if key != "h_n8":
            assert torch.equal(carried[key], t), key
    assert tparams.proof_group.g.eq(
        tcurve.tom_ops.unpack_points(carried["g_t"][1:2])[0]
    )
    assert tparams.nist_group.h.eq(
        tcurve.p256_ops.unpack_points(carried["h_n"][1:2])[0]
    )
    p = p256.p
    f = tcurve.p256_ops.f
    ref = [f.unpack(carried["h_n8"][..., k, :]) for k in range(3)]
    port = [f.unpack(ttabs["h_n8"][..., k, :]) for k in range(3)]
    assert ttabs["h_n8"].shape == (32, 256, 3, 9)
    for X, Y, Z, x, y, z in zip(*ref, *port):
        if Z == 0:
            assert (X, Z, x, y, z) == (0, 0, 0, 1, 0)
        else:
            zinv = pow(Z, -1, p)
            assert (X * zinv % p, Y * zinv % p, z) == (x, y, 1)


def test_mixed_comb_forms(params):
    """The Tom-256 comb tables the kernel reads are x * 2^288 mod p of the
    canonical ones, entry for entry, and the canonical tables are the
    reference's g_t8 then h_t8, carried across."""
    _, _, jtabs, ttabs = params
    gh = ttabs["gh_t8"]
    f = tcurve.tom_ops.f
    assert gh.canon.shape == gh.mont.shape == (64, 256, 5, 9)
    R = 1 << 288
    assert f.unpack(gh.mont) == [x * R % f.p for x in f.unpack(gh.canon)]
    carried = carry.tables_from_jax({k: np.asarray(jtabs[k]) for k in ("g_t8", "h_t8")})
    assert torch.equal(gh.canon, torch.cat([carried["g_t8"], carried["h_t8"]]))
    assert torch.equal(ttabs["g_t8"], gh.canon[:32]) and torch.equal(ttabs["h_t8"], gh.canon[32:])


def test_weier_comb_forms(params):
    """The P-256 comb table of h the kernel reads is x * 2^288 mod p of the
    canonical one, entry for entry (FieldT.pack_mont), the identity
    entries (0, 1, 0) -> (0, 2^288 mod p, 0) included; h_n8 is the
    canonical form."""
    _, _, _, ttabs = params
    comb = ttabs["comb_h_n8"]
    f = tcurve.p256_ops.f
    assert isinstance(comb, tcurve.WeierComb)
    assert comb.canon.shape == comb.mont.shape == (32, 256, 3, 9)
    assert torch.equal(comb.mont, f.pack_mont(f.unpack(comb.canon)).reshape(comb.mont.shape))
    R = (1 << 288) % f.p
    assert f.unpack(comb.mont[:, 0]) == [0, R, 0] * 32
    assert f.unpack(comb.canon[:, 0]) == [0, 1, 0] * 32
    assert ttabs["h_n8"] is comb.canon


def _nib(scs):
    return torch.from_numpy(tcurve.nibble_digits(scs).astype(np.uint8))


def _affine(jops, tops, ref, got):
    """Reference and port points as (x, y, infinity) canonical integers."""
    jx, jy, jinf = jops.to_affine(ref)
    x, y, inf = tops.to_affine(got)
    assert tops.f.unpack(x) == jops.f.unpack(jx)
    assert tops.f.unpack(y) == jops.f.unpack(jy)
    assert inf.tolist() == np.asarray(jinf).tolist()


@pytest.mark.parametrize("name", list(CURVES))
def test_window_table_identity_point(name):
    """window_table (CPU: ops.table) against the reference's table on
    random points with the identity among them: the same integers, and 16
    identities for the identity."""
    tops, jops, g = CURVES[name]
    rs = np.random.RandomState(62 + len(name))
    pts = _points(g, rs, 2) + [g.identity()]
    tab = tcurve.window_table(tops, tops.pack_points(pts))
    jtab = jops.table(jnp.asarray(jops.pack_points(pts)))
    assert _tcoords(tops, tab.reshape(-1, tops.NCOORD, 9)) == _coords(
        jops, jtab.reshape(-1, jops.NCOORD, jtab.shape[-1])
    )
    assert tops.is_identity(tab[2]).all()
    for k, e in enumerate(tops.unpack_points(tab[0])):
        assert e.eq(pts[0].mul(g.new_scalar(k)) if k else g.identity())


@pytest.mark.parametrize("n", [0, 1, 2, 3, 5, 12, 16, 17, 33, 64, 65, 130])
@pytest.mark.parametrize("name", list(CURVES))
def test_sum_reduce_vs_reference(name, n):
    """sum_reduce (CPU: tree_sum's plain version, ``ops.sum_reduce``)
    against the reference's ``CurveOps.sum_reduce`` over two columns of n
    projective points, each scaled by a random lambda, the identity among
    them: the same projective integers (the plain tree's pairing order,
    an odd level carrying its last point), along axis 0 and along axis 1,
    and the host sum of each column; n up to and past the kernel's 64
    points a column in shared memory."""
    tops, jops, g = CURVES[name]
    rs = np.random.RandomState(70 + n)
    M, C, p = 2, tops.NCOORD, tops.f.p
    pts = _points(g, rs, n * M)
    if n >= 3:
        pts[3] = g.identity()
    coords = []
    for pt in pts:
        lam = int.from_bytes(rs.bytes(40), "little") % (p - 1) + 1
        coords.extend(c * lam % p for c in tops._host_coords(pt))
    P = tops.f.pack(coords).reshape(n, M, C, 9)
    got = tcurve.sum_reduce(tops, P)
    want = _coords(jops, jops.sum_reduce(jnp.asarray(jops.f.pack(coords).reshape(n, M, C, jops.f.nlimbs))))
    assert got.shape == (M, C, 9)
    assert _tcoords(tops, got) == want
    assert _tcoords(tops, tcurve.sum_reduce(tops, P.transpose(0, 1), axis=1)) == want
    for m, r in enumerate(tops.unpack_points(got)):
        host = g.identity()
        for pt in pts[m::M]:
            host = host.add(pt)
        assert r.eq(host)


def test_shamir_vs_double_mul_tables(params):
    """window_table + shamir (CPU: the plain versions) against the
    reference's table + double_mul_tables: the same operations in the same
    order, so the projective coordinates are the same integers.  Shapes of
    phase A: one shared table against per-row tables, then [N, 2] rows
    with a zero-digit row."""
    _, tparams, jtabs, ttabs = params
    tops, jops = tcurve.p256_ops, jcurve.p256_ops
    rs = np.random.RandomState(61)
    P = _points(p256, rs, 2)
    a, b, c = ([int.from_bytes(rs.bytes(32), "little") % p256.order for _ in range(2)] for _ in range(3))
    tab = tcurve.window_table(tops, tops.pack_points(P))
    jtab = jops.table(jnp.asarray(jops.pack_points(P)))
    assert _tcoords(tops, tab.reshape(-1, 3, 9)) == _coords(jops, jtab.reshape(-1, 3, jtab.shape[-1]))
    got = tcurve.shamir(ttabs["G"], _nib(a), tab, _nib(b))
    ref = jops.double_mul_tables(
        jtabs["G"], jnp.asarray(jcurve.nibble_digits(a)), jtab, jnp.asarray(jcurve.nibble_digits(b))
    )
    assert _tcoords(tops, got) == _coords(jops, ref)
    G = p256.generator()
    for r, x, y, pt in zip(tops.unpack_points(got), a, b, P):
        assert r.eq(G.dblmul(p256.new_scalar(x), pt, p256.new_scalar(y)))
    tp = torch.stack([tab, ttabs["G"].expand_as(tab)], dim=1)
    dP = torch.stack([_nib(a), _nib(c)], dim=1)
    dQ = torch.stack([_nib(b), torch.zeros_like(_nib(b))], dim=1)
    # a second shared table: the window table of h, the reference's "h_n"
    tab_h = tops.table(tops.pack_points([tparams.nist_group.h]))[0]
    got2 = tcurve.shamir(tp, dP, tab_h, dQ)
    jtp = jnp.stack([jtab, jnp.broadcast_to(jtabs["G"], jtab.shape)], axis=1)
    ref2 = jops.double_mul_tables(jtp, jnp.asarray(dP.numpy()), jtabs["h_n"], jnp.asarray(dQ.numpy()))
    assert _tcoords(tops, got2.reshape(-1, 3, 9)) == _coords(jops, ref2.reshape(-1, 3, ref2.shape[-1]))


def test_comb4_vs_reference():
    """comb4_table + mul_comb4 (CPU: the plain versions) against the
    reference's: the same construction and scan order, exact; and against
    host multiplication."""
    tops, jops = tcurve.p256_ops, jcurve.p256_ops
    rs = np.random.RandomState(62)
    R = _points(p256, rs, 2)
    scs = [int.from_bytes(rs.bytes(32), "little") % p256.order for _ in range(6)]
    scs[5] = 0
    tab = tcurve.comb4_table(tops.pack_points(R))
    jtab = jops.comb4_table(jnp.asarray(jops.pack_points(R)))
    assert _tcoords(tops, tab.reshape(-1, 3, 9)) == _coords(jops, jtab.reshape(-1, 3, jtab.shape[-1]))
    got = tcurve.mul_comb4(tab, _nib(scs).reshape(2, 3, 64))
    ref = jops.mul_comb4(jtab, jnp.asarray(jcurve.nibble_digits(scs).reshape(2, 3, 64)))
    assert _tcoords(tops, got.reshape(-1, 3, 9)) == _coords(jops, ref.reshape(-1, 3, ref.shape[-1]))
    assert bool(tops.is_identity(got[1, 2]))
    assert torch.equal(tops.comb4_bases(tops.pack_points(R)), tab[:, :, 1])
    for k, r in enumerate(tops.unpack_points(got.reshape(-1, 3, 9))):
        assert r.eq(R[k // 3].mul(p256.new_scalar(scs[k])))


def test_comb_weier_vs_mul_comb(params):
    """The P-256 comb (CPU: the plain version) on the port's affine table
    against the reference's mul_comb on its projective table: the same
    points, compared affine.  The port's call is phase A's merged one,
    [N, 81] rows of the rounds' r digits and com_r's as the 81st; the
    reference's are its two, Hr on [N, 80] and Hc on [N]."""
    _, tparams, jtabs, ttabs = params
    rs = np.random.RandomState(63)
    N, rounds = 2, 80
    order = p256.order
    r = [[int.from_bytes(rs.bytes(32), "little") % order for _ in range(rounds)] for _ in range(N)]
    com_r = [int.from_bytes(rs.bytes(32), "little") % order for _ in range(N)]
    r[0][0] = 0
    com_r[1] = 0
    rows = [r[i] + [com_r[i]] for i in range(N)]
    d8 = torch.from_numpy(tcurve.byte_digits([v for row in rows for v in row]).astype(np.uint8))
    got = tcurve.comb_weier(ttabs["comb_h_n8"], d8.reshape(N, rounds + 1, 32))
    assert got.shape == (N, rounds + 1, 3, 9)
    jops = jcurve.p256_ops
    ref_r = jops.mul_comb(jtabs["h_n8"], jnp.asarray(jcurve.byte_digits([v for row in r for v in row])))
    ref_c = jops.mul_comb(jtabs["h_n8"], jnp.asarray(jcurve.byte_digits(com_r)))
    _affine(jops, tcurve.p256_ops, ref_r, got[:, :rounds].reshape(-1, 3, 9))
    _affine(jops, tcurve.p256_ops, ref_c, got[:, rounds])
    assert bool(tcurve.p256_ops.is_identity(got[0, 0])) and bool(tcurve.p256_ops.is_identity(got[1, rounds]))
    h = tparams.nist_group.h
    for i in range(N):
        for j in (1, rounds - 1, rounds):
            assert tcurve.p256_ops.unpack_points(got[i, j : j + 1])[0].eq(h.mul(p256.new_scalar(rows[i][j])))
    with pytest.raises(TypeError):  # a bare table: only a WeierComb reaches the wrapper
        tcurve.comb_weier(ttabs["h_n8"], d8[:1])
