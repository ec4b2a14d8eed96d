"""Parameter set-up on the port: the comb tables of the Pedersen bases
(``zkecdsa_tpu_torch.ops.curve_ops.comb_table`` and ``comb_table_mixed``,
on the CPU their plain versions) against the JAX package's
``p256_ops.comb_table`` and ``tom_ops.comb_table_mixed`` and against the
Python-integer host oracle (``DeviceParams._host_comb_weier``,
``_host_comb_mixed``), for the default h (h = r*g) and for a
``hash_to_point`` h (the ``hardened_pedersen`` base).

Both packages' tables are the same group elements; the Tom-256 tables are
affine in both, so their canonical rows are the same integers, while the
reference's P-256 table is projective and the port's affine (Z = 1): it is
compared as affine points, its identity entries included.  Every
comparison is exact.  tests/test_torch_kernels.py and chip_smoke.py hold
the kernels (``comb8_bases``, ``comb8_entries``) against these plain
versions on the card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zkecdsa_tpu.curves.group import Point as JPoint
from zkecdsa_tpu.ops import curve_ops as jcurve
from zkecdsa_tpu.serde import read_json as jread_json
from zkecdsa_tpu.serde import write_json as jwrite_json
from zkecdsa_tpu.utils import rng as jrng
from zkecdsa_tpu.zkp_attest_list import SystemParametersList as JParams
from zkecdsa_tpu.zkp_attest_list import generate_params_list as jgenerate_params
from zkecdsa_tpu_torch import carry
from zkecdsa_tpu_torch.commit.pedersen import hash_to_point
from zkecdsa_tpu_torch.curves.group import Point
from zkecdsa_tpu_torch.curves.instances import p256, tomEdwards256
from zkecdsa_tpu_torch.ops import curve_ops as tcurve
from zkecdsa_tpu_torch.ops.field import P256_P, TOM_P
from zkecdsa_tpu_torch.protocol.batch import DeviceParams
from zkecdsa_tpu_torch.serde import write_json

# One intra-op thread: the suite runs several worker processes on the same
# cores, and an oversubscribed OpenMP pool spins instead of working.
torch.set_num_threads(1)

CASES = ["default", "hash_to_point"]


@pytest.fixture(scope="module")
def params():
    """One parameter set made by the reference, carried to the port."""
    with jrng.deterministic(71):
        jparams = jgenerate_params()
    return carry.params_from_jax(jwrite_json(JParams, jparams))


def _bases(params, case):
    """(P-256 h, Tom-256 g, Tom-256 h) of the case, as port host points."""
    g = params.proof_group.g
    if case == "default":
        return params.nist_group.h, g, params.proof_group.h
    return (hash_to_point(p256, p256.generator().to_bytes()), g,
            hash_to_point(tomEdwards256, g.to_bytes()))


@pytest.fixture(scope="module")
def tables(params):
    """Per case: the bases, the port's plain tables (P-256 WeierComb of
    h; Tom-256 MixedComb of g then h) and the reference's, carried to
    canonical limbs."""
    out = {}
    for case in CASES:
        h_n, g_t, h_t = _bases(params, case)
        port_n = tcurve.comb_table(tcurve.p256_ops.pack_points([h_n])[0])
        port_t = tcurve.comb_table_mixed(tcurve.tom_ops.pack_points([g_t, h_t]))
        jn, jt = jcurve.p256_ops, jcurve.tom_ops
        ref_n = jn.comb_table(jnp.asarray(jn.pack_points([_jpoint(h_n)])[0]))
        ref_t = [jt.comb_table_mixed(jnp.asarray(jt.pack_points([_jpoint(b)])[0])) for b in (g_t, h_t)]
        carried = carry.tables_from_jax({
            "h_n8": np.asarray(ref_n),
            "g_t8": np.asarray(ref_t[0]),
            "h_t8": np.asarray(ref_t[1]),
        })
        out[case] = dict(bases=(h_n, g_t, h_t), port_n=port_n, port_t=port_t, ref=carried)
    return out


def _jpoint(pt):
    """A port host point as the reference's, across the wire."""
    return jread_json(JPoint, write_json(Point, pt))


def _affine_ints(t: torch.Tensor) -> list[tuple[int, int, int]]:
    """P-256 table [..., 3, 9] (projective or affine) -> (x, y, z) per
    entry with z in {0, 1}: affine points, the identity as (0, 1, 0)."""
    p = p256.p
    cols = [P256_P.unpack(t[..., k, :]) for k in range(3)]
    out = []
    for X, Y, Z in zip(*cols):
        if Z == 0:
            out.append((0, 1, 0))
        else:
            zinv = pow(Z, -1, p)
            out.append((X * zinv % p, Y * zinv % p, 1))
    return out


@pytest.mark.parametrize("case", CASES)
def test_comb_table_vs_jax(tables, case):
    """The P-256 comb table of h: the reference's projective table and the
    port's affine one are the same points, the 32 identity entries
    included; the port's identity is (0, 1, 0) as comb_weier reads it."""
    t = tables[case]
    port, ref = t["port_n"].canon, t["ref"]["h_n8"]
    assert port.shape == (32, 256, 3, 9) and port.dtype == torch.int32
    got = _affine_ints(port)
    assert got == _affine_ints(ref)
    assert [got[256 * j] for j in range(32)] == [(0, 1, 0)] * 32
    assert P256_P.unpack(port[..., 2, :]) == [0 if d == 0 else 1 for _ in range(32) for d in range(256)]


@pytest.mark.parametrize("case", CASES)
def test_comb_table_mixed_vs_jax(tables, case):
    """The Tom-256 mixed tables of g then h equal the reference's
    comb_table_mixed of each, carried across, exactly; the Montgomery
    form is x * 2^288 mod p of the canonical one, entry for entry."""
    t = tables[case]
    comb, ref = t["port_t"], t["ref"]
    assert comb.canon.shape == comb.mont.shape == (64, 256, 5, 9)
    assert torch.equal(comb.canon, torch.cat([ref["g_t8"], ref["h_t8"]]))
    R = 1 << 288
    assert TOM_P.unpack(comb.mont) == [x * R % TOM_P.p for x in TOM_P.unpack(comb.canon)]
    ident = TOM_P.unpack(comb.canon[:, 0, :2])  # d = 0: the affine identity (0, 1)
    assert ident == [0, 1] * 64


@pytest.mark.parametrize("case", CASES)
def test_comb_tables_vs_host_oracle(tables, case):
    """The plain tables equal the Python-integer host oracle's, in both
    forms (the Montgomery form of the P-256 table: the oracle's through
    FieldT.pack_mont)."""
    t = tables[case]
    h_n, g_t, h_t = t["bases"]
    host_n = DeviceParams._host_comb_weier(h_n)
    assert torch.equal(t["port_n"].canon, host_n)
    assert torch.equal(t["port_n"].mont, P256_P.pack_mont(P256_P.unpack(host_n)).reshape(host_n.shape))
    host = tcurve.MixedComb.pack(DeviceParams._host_comb_mixed(g_t) + DeviceParams._host_comb_mixed(h_t))
    assert torch.equal(t["port_t"].canon, host.canon)
    assert torch.equal(t["port_t"].mont, host.mont)


@pytest.mark.parametrize("ops,g", [(tcurve.p256_ops, p256), (tcurve.tom_ops, tomEdwards256)],
                         ids=["p256", "tomEdwards256"])
def test_comb8_bases_lsb_first(params, ops, g):
    """Window base j is 2^(8j) * base (LSB-first, where comb4_bases is
    MSB-first), for two bases at once; the wrapper's CPU path is the
    plain version."""
    pts = [g.generator(), _bases(params, "hash_to_point")[0 if g is p256 else 2]]
    P = ops.pack_points(pts)
    bases = tcurve.comb8_bases(ops, P)
    assert bases.shape == (2, 32, ops.NCOORD, 9)
    assert torch.equal(bases, ops.comb8_bases(P))
    for r, pt in enumerate(pts):
        got = ops.unpack_points(bases[r])
        for j in range(32):
            assert got[j].eq(pt.mul(g.new_scalar(1 << (8 * j))))


def test_comb8_entries_wrapper_is_plain_on_cpu(tables):
    """comb8_entries on CPU window bases is the plain version, in both
    curves' forms: (canonical, Montgomery), the P-256 pair the
    WeierComb's, the Tom-256 pair the MixedComb's."""
    h_n, g_t, _ = tables["default"]["bases"]
    bn = tcurve.comb8_bases(tcurve.p256_ops, tcurve.p256_ops.pack_points([h_n]))
    canon, mont = tcurve.comb8_entries(tcurve.p256_ops, bn)
    assert torch.equal(canon[0], tables["default"]["port_n"].canon)
    assert torch.equal(mont[0], tables["default"]["port_n"].mont)
    bt = tcurve.comb8_bases(tcurve.tom_ops, tcurve.tom_ops.pack_points([g_t]))
    canon, mont = tcurve.comb8_entries(tcurve.tom_ops, bt)
    assert torch.equal(canon[0], tables["default"]["port_t"].canon[:32])
    assert torch.equal(mont[0], tables["default"]["port_t"].mont[:32])


@pytest.mark.parametrize("f", [P256_P, TOM_P], ids=lambda f: f.name)
@pytest.mark.parametrize("n", [1, 2, 3, 7, 64, 257])
def test_wbatch_inv_vs_integers(f, n):
    """The plain batch inverse: one product tree over n values with zeros
    among them (0 maps to 0), against Python's pow(x, -1, p)."""
    rs = np.random.RandomState(n)
    vals = [int.from_bytes(rs.bytes(40), "little") % f.p for _ in range(n)]
    vals[n // 2] = 0
    vals[-1] = f.p - 1
    got = f.unpack(f.canon(f.wbatch_inv(f.to_work(f.pack(vals)))))
    assert got == [pow(v, -1, f.p) if v else 0 for v in vals]
