"""The port's MSM backends against the JAX package's, on the CPU: the
Pippenger bucket MSM (``zkecdsa_tpu_torch.ops.msm_bucket``), the per-term
``msm`` and ``msm_ladder``, and the scalar verifier's device MSM
(``zkecdsa_tpu_torch.protocol.verify``).  The batched verifier on the
bucket backend (``Config.pippenger_min_t``) is in tests/test_torch_verify.py.

Inputs come from a numpy seed and cross as integers, proofs as serde
JSON.  Where both packages take the same sequence of point operations the
canonical projective coordinates are compared exactly; elsewhere (the
reference pads its MSMs with identity terms) the host points are.
tests/test_torch_kernels.py holds the kernels against these plain
versions on the card.
"""

import hashlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zkecdsa_tpu import ecdsa as jecdsa
from zkecdsa_tpu.curves import multimult as jmm
from zkecdsa_tpu.ops import curve_ops as jcurve
from zkecdsa_tpu.ops import msm_bucket as jmb
from zkecdsa_tpu.protocol import verify as jverify
from zkecdsa_tpu.serde import write_json as jwrite_json
from zkecdsa_tpu.utils import rng as jrng
from zkecdsa_tpu.zkp_attest_list import SignatureProofList as JProof
from zkecdsa_tpu.zkp_attest_list import SystemParametersList as JParams
from zkecdsa_tpu.zkp_attest_list import generate_params_list as jgenerate_params
from zkecdsa_tpu.zkp_attest_list import prove_signature_list as jprove
from zkecdsa_tpu.zkp_attest_list import verify_signature_list as jverify_host
from zkecdsa_tpu_torch import carry
from zkecdsa_tpu_torch.curves import multimult as tmm
from zkecdsa_tpu_torch.curves.instances import p256, tomEdwards256
from zkecdsa_tpu_torch.ops import curve_ops as tcurve
from zkecdsa_tpu_torch.ops import msm_bucket as tmb
from zkecdsa_tpu_torch.protocol import verify as tverify
from zkecdsa_tpu_torch.serde import read_json
from zkecdsa_tpu_torch.utils import rng as trng
from zkecdsa_tpu_torch.zkp_attest_list import SignatureProofList, verify_signature_list

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


def _coords(jops, arr) -> list[list[int]]:
    """Reference digit array [B, C, L] -> per-point canonical coordinates."""
    a = np.asarray(arr)
    cols = [jops.f.unpack(a[:, k]) for k in range(a.shape[1])]
    return [list(c) for c in zip(*cols)]


def _port_coords(ops, t: torch.Tensor) -> list[list[int]]:
    a = t.reshape(-1, ops.NCOORD, t.shape[-1])
    cols = [ops.f.unpack(a[:, k]) for k in range(ops.NCOORD)]
    return [list(c) for c in zip(*cols)]


def _terms(g, rs, N, T):
    """N rows of T points and scalars: random, then the edge scalars 0, 1,
    order - 1 and a duplicate at the head of each row, and an identity
    point with scalar 0 at its end."""
    G = g.generator()
    pts = [G.mul(g.new_scalar(int.from_bytes(rs.bytes(32), "big") % g.order)) for _ in range(N * T)]
    scs = [[int.from_bytes(rs.bytes(32), "big") % g.order for _ in range(T)] for _ in range(N)]
    for i in range(N):
        scs[i][:4] = [0, 1, g.order - 1, scs[i][4]]
        pts[i * T + T - 1], scs[i][T - 1] = g.identity(), 0
    return pts, scs


def _host_sum(g, pts, scs):
    acc = g.identity()
    for p, s in zip(pts, scs):
        acc = acc.add(p.mul(g.new_scalar(s)))
    return acc


@pytest.mark.parametrize("window", [5, 6])
@pytest.mark.parametrize("name", list(CURVES))
def test_msm_bucket_rows_matches_reference(name, window):
    """The plain bucket MSM takes the reference's schedule on its chunk
    layout: the same canonical projective coordinates, row by row."""
    ops, jops, g = CURVES[name]
    rs = np.random.RandomState(10 + window)
    N, T = 2, 24
    pts, scs = _terms(g, rs, N, T)
    got = tmb.msm_bucket_rows(ops, ops.pack_points(pts).reshape(N, T, ops.NCOORD, -1), scs, window)
    jarr = jnp.asarray(jops.pack_points(pts)).reshape(N, T, jops.NCOORD, -1)
    ref = jmb.msm_bucket_rows(jops, jarr, scs, window)
    assert _port_coords(ops, got) == _coords(jops, ref)
    host = ops.unpack_points(got)
    assert host[0].eq(_host_sum(g, pts[:T], scs[0]))


def test_bucket_layout_matches_reference():
    rs = np.random.RandomState(12)
    T, w = 96, 5
    rows = [[int.from_bytes(rs.bytes(32), "big") for _ in range(T)] for _ in range(2)]
    rows[0][:3] = [0, 0, rows[0][5]]
    ci, bc, meta = tmb.bucket_layout(rows, T, w)
    jci, jbc, jmeta = jmb.bucket_layout(rows, T, w)
    assert meta == jmeta
    assert np.array_equal(ci, jci) and np.array_equal(bc, jbc)


@pytest.mark.parametrize("window", [5, 6, 7])
def test_window_digits_match_reference(window):
    """The reference's digit computation (``msm_bucket.py:76-81``), on
    rows of which one is shorter than T (padded with zero scalars)."""
    rs = np.random.RandomState(13)
    T = 9
    rows = [[int.from_bytes(rs.bytes(32), "big") for _ in range(T)], [(1 << 256) - 1, 1, 0]]
    got = tmb.window_digits(rows, T, window)
    D = -(-256 // window)
    flat = [s for row in rows for s in row + [0] * (T - len(row))]
    bits = np.pad(jcurve.scalar_bits(flat, 256), ((0, 0), (D * window - 256, 0)))
    w8 = (1 << np.arange(window - 1, -1, -1)).astype(np.int64)
    want = (bits.reshape(2, T, D, window).astype(np.int64) @ w8).transpose(0, 2, 1)
    assert got.dtype == np.uint8 and got.shape == (2, D, T)
    assert np.array_equal(got, want)
    with pytest.raises(ValueError):
        tmb.window_digits(rows, 2, window)


@pytest.mark.parametrize("name", list(CURVES))
def test_msm_and_ladder_match_reference(name):
    """``msm`` (per-term window multiplies, then a tree) and
    ``msm_ladder`` (256 masked steps per term, then a tree): the
    reference's schedules, exactly."""
    ops, jops, g = CURVES[name]
    rs = np.random.RandomState(14)
    pts, scs = _terms(g, rs, 1, 7)
    scs = scs[0]
    P, jP = ops.pack_points(pts), jnp.asarray(jops.pack_points(pts))
    nib = tcurve.nibble_digits(scs)
    got = tcurve.msm(ops, P, torch.from_numpy(nib.astype(np.uint8)))
    ref = jops.msm(jP, jnp.asarray(nib))
    assert _port_coords(ops, got) == _coords(jops, ref[None])
    bits = tcurve.scalar_bits(scs)
    assert np.array_equal(bits, jcurve.scalar_bits(scs))
    lad = tcurve.msm_ladder(ops, P[None], torch.from_numpy(bits)[None])
    jlad = jops.msm_ladder(jP[None], jnp.asarray(bits)[None])
    assert _port_coords(ops, lad) == _coords(jops, jlad)
    assert ops.unpack_points(lad)[0].eq(_host_sum(g, pts, scs))


@pytest.mark.parametrize("name", list(CURVES))
def test_device_msm_matches_reference_and_host(name):
    ops, jops, g = CURVES[name]
    rs = np.random.RandomState(15)
    pts, scs = _terms(g, rs, 1, 10)
    scs = scs[0]
    got = tverify.device_msm(g, pts, scs, device="cpu")
    multi = tmm.MultiMult(g)
    for p, s in zip(pts, scs):
        multi.insert(p, g.new_scalar(s))
    assert got.eq(multi.evaluate())
    jg = jcurve.p256_ops.group if name == "p256" else jcurve.tom_ops.group
    jpts = [type(jg.generator())(jg, *ops._host_coords(p)) for p in pts]
    ref = jverify.device_msm(jg, jpts, scs)
    assert got.to_affine() == ref.to_affine()


@pytest.fixture(scope="module")
def proof20():
    """One reference proof of 20 exp rounds (the scalar verifier checks
    20) in a ring of 4, its tampered twin (GK response f[0] = f[1]), and
    the parameters on both sides."""
    with jrng.deterministic(41):
        params = jgenerate_params(sec_level=20)
        kp = jecdsa.generate_keypair()
        msg = b"msm backends"
        sig = jecdsa.sign(kp, msg)
        pub = jecdsa.export_public_raw(kp)
        mh = hashlib.sha256(msg).digest()
        ring = [jecdsa.key_to_int(pub), 31, 37, 41]
    with jrng.scoped(jrng.DeterministicSource(4343)):
        proof = jprove(params, mh, sig, pub, 0, ring)
    wire = jwrite_json(JProof, proof)
    bad = read_json(SignatureProofList, wire)
    bad.membershipProof.f[0] = bad.membershipProof.f[1]
    tparams = carry.params_from_jax(jwrite_json(JParams, params))
    return params, tparams, mh, ring, wire, bad


def test_scalar_verifier_on_device_backend(proof20, monkeypatch):
    """``verify_signature_list`` under ``device_msm_backend("cpu")``: the
    reference's verdicts under its own backend, honest and tampered; the
    backend took every MSM of 8 or more terms (3 for the honest proof, 1
    for the tampered one, whose GK check returns first) and is removed
    afterwards."""
    from zkecdsa_tpu.serde import read_json as jread_json

    params, tparams, mh, ring, wire, bad = proof20
    calls = []
    real = tverify.device_msm

    def spy(group, points, scalars, device=None):
        calls.append((group.name, len(points)))
        return real(group, points, scalars, device)

    monkeypatch.setattr(tverify, "device_msm", spy)
    got = []
    for k, proof in enumerate((read_json(SignatureProofList, wire), bad)):
        calls.clear()
        with trng.deterministic(50 + k), tverify.device_msm_backend("cpu"):
            got.append(verify_signature_list(tparams, mh, ring, proof))
        assert tmm._MSM_BACKEND is None
        assert len(calls) == (3 if k == 0 else 1) and all(n >= 8 for _, n in calls), calls
        assert {c[0] for c in calls} == ({"p256", "tomEdwards256"} if k == 0 else {"tomEdwards256"})
    jbad = jread_json(JProof, jwrite_json(JProof, jread_json(JProof, wire)))
    jbad.membershipProof.f[0] = jbad.membershipProof.f[1]
    with jverify.device_msm_backend():
        ref = [jverify_host(params, mh, ring, jread_json(JProof, wire)), jverify_host(params, mh, ring, jbad)]
    assert jmm._MSM_BACKEND is None
    assert got == ref == [True, False]


def test_device_backend_removed_on_error():
    with pytest.raises(KeyError):
        with tverify.device_msm_backend("cpu"):
            assert tmm._MSM_BACKEND is not None
            raise KeyError("inside the scope")
    assert tmm._MSM_BACKEND is None
