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
from torch_ladder_edges import ladder_edge_rows

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


def _fold_model(g, S, window, segs, groups):
    """The schedule of ``csrc/bucket.cu``'s bucket_fold on host points: per
    window, ``segs`` segments [lo, hi] of the buckets 1..B-1, each its
    running sums from the top down (run, and acc = sum (b - lo + 1) S_b),
    then acc + (lo - 1) * run by a double-and-add over the bits of the last
    segment's lo - 1, the segments summed by the kernel's tree; then the
    windows by Horner in ``groups`` groups of ceil(D / groups) from the
    top (the first padded with identity windows), chained by w * Lg
    doublings and an add.  S[d][b] host points -> the MSM's point."""
    D, B = len(S), 1 << window
    ident = g.identity()
    nbits = (((segs - 1) * (B - 1)) // segs).bit_length()
    W = []
    for d in range(D):
        pieces = []
        for j in range(segs):
            lo, hi = 1 + j * (B - 1) // segs, (j + 1) * (B - 1) // segs
            run = acc = S[d][hi]
            for b in range(hi - 1, lo - 1, -1):
                run = run.add(S[d][b])
                acc = acc.add(run)
            if nbits:
                m = lo - 1
                t = run if (m >> (nbits - 1)) & 1 else ident
                for i in range(nbits - 2, -1, -1):
                    t = t.dbl()
                    t = t.add(run if (m >> i) & 1 else ident)
                acc = acc.add(t)
            pieces.append(acc)
        h = 1
        while h < segs:
            for j in range(0, segs, 2 * h):
                if j + h < segs:
                    pieces[j] = pieces[j].add(pieces[j + h])
            h *= 2
        W.append(pieces[0])
    Lg = -(-D // groups)
    parts = []
    for gi in range(groups):
        base = D - (groups - gi) * Lg
        acc = W[base] if base >= 0 else ident
        for i in range(1, Lg):
            for _ in range(window):
                acc = acc.dbl()
            acc = acc.add(W[base + i] if base + i >= 0 else ident)
        parts.append(acc)
    acc = parts[0]
    for part in parts[1:]:
        for _ in range(window * Lg):
            acc = acc.dbl()
        acc = acc.add(part)
    return acc


@pytest.mark.parametrize("segs", [1, 2, 3, 4, "most"])
@pytest.mark.parametrize("window", [5, 6])
@pytest.mark.parametrize("name", list(CURVES))
def test_fold_schedule_matches_plain(name, window, segs):
    """The bucket_fold kernel's schedule (segments, their (lo - 1) * run
    multiples, the segment tree, the grouped Horner) on host points gives
    bucket_fold_plain's group element: for 1-4 segments a window (3 does
    not divide B - 1), for the most the kernel takes (min(32, B - 1):
    one-bucket segments at w = 5), for the plan's Horner groups, one group
    and eight; window 0 all empty, bucket 0 ignored."""
    ops, _, g = CURVES[name]
    rs = np.random.RandomState(20 + window)
    D, B = tmb.n_windows(window), 1 << window
    segs = min(32, B - 1) if segs == "most" else segs
    G = g.generator()
    pool = [G.mul(g.new_scalar(int.from_bytes(rs.bytes(32), "big") % g.order)) for _ in range(6)]
    S = [[pool[rs.randint(6)] if rs.rand() < 0.8 else g.identity() for _ in range(B)] for _ in range(D)]
    S[0] = [pool[0]] + [g.identity()] * (B - 1)  # an empty window; bucket 0 holds a point, ignored
    plain = tmb.bucket_fold_plain(ops, ops.pack_points([p for row in S for p in row]).reshape(1, D, B, ops.NCOORD, -1),
                                  window)
    want = ops.unpack_points(plain)[0]
    plan = tmb.bucket_plan(ops, 1, window, 0, segs=segs)
    for groups in sorted({1, plan.groups, 8}):
        assert _fold_model(g, S, window, segs, groups).eq(want)


# teams of bucket_fold an SM keeps resident: the H100's occupancy of the
# fold kernel (two blocks of four warps an SM at 218-240 registers), with
# 132 and 114 SMs; the card's own come from bucket_teams
FOLD_WARPS = 8


@pytest.mark.parametrize("sms", [132, 114], ids=["h100_sxm", "h100_pcie"])
@pytest.mark.parametrize("name,N,T,window", [
    ("p256", 256, 48, 5), ("tomEdwards256", 256, 760, 5), ("tomEdwards256", 16, 8192, 6),
    ("tomEdwards256", 1, 8193, 7), ("p256", 1, 43, 5),
])
def test_bucket_plan(name, N, T, window, sms):
    """A team a bucket up to 64 buckets (the faster form at every shape
    timed), a lane past them; the fold's blocks fit the card at once where
    they can: the most segments (a power of two) with one pass, else one
    segment and the fewest passes, else one block a row; the Horner
    groups with the shortest chain; the keywords force the geometry, and
    what the kernels cannot take raises."""
    ops = CURVES[name][0]
    teams_res = sms * FOLD_WARPS * 8
    D, B = tmb.n_windows(window), 1 << window
    plan = tmb.bucket_plan(ops, N, window, teams_res)
    assert plan.lanes == (4 if B <= 64 else 1)
    top = min(32, B - 1)
    assert plan.segs & (plan.segs - 1) == 0 and 1 <= plan.segs <= top

    def blocks(segs, wpt):
        return -(-D // (tmb.FOLD_TEAMS // segs * wpt))

    def fits(segs, wpt):
        return N * blocks(segs, wpt) * tmb.FOLD_TEAMS <= teams_res

    assert plan.blocks_per_row == blocks(plan.segs, plan.wpt)
    wpp = tmb.FOLD_TEAMS // plan.segs
    assert (plan.blocks_per_row - 1) * wpp * plan.wpt < D <= plan.blocks_per_row * wpp * plan.wpt
    if plan.wpt == 1:
        assert fits(plan.segs, 1) or plan.blocks_per_row == 1 or plan.segs == 1
        assert 2 * plan.segs > top or not fits(2 * plan.segs, 1)  # the most that fit
    else:  # one segment, the fewest passes that fit, else one block a row
        assert plan.segs == 1 and not fits(1, plan.wpt - 1)
        assert fits(1, plan.wpt) or plan.blocks_per_row == 1
    expect = {(256, 48): (1, 2), (256, 760): (1, 2), (16, 8192): (8, 1), (1, 8193): (32, 1), (1, 43): (16, 1)}
    assert (plan.segs, plan.wpt) == expect[(N, T)]
    dbl, add = (4, 5) if ops.NCOORD == 3 else (3, 3)

    def chain(gr):
        Lg = -(-D // gr)
        return (Lg - 1) * (window * dbl + add) + (gr - 1) * (window * Lg * dbl + add)

    assert 1 <= plan.groups <= 8 and chain(plan.groups) == min(chain(gr) for gr in range(1, 9))
    for segs in (1, 3, top):
        forced = tmb.bucket_plan(ops, N, window, teams_res, segs=segs)
        assert forced.segs == segs and forced.blocks_per_row == blocks(segs, forced.wpt)
    for wpt in (1, 2, D):
        forced = tmb.bucket_plan(ops, N, window, teams_res, wpt=wpt)
        assert forced.wpt == wpt and forced.blocks_per_row == blocks(forced.segs, wpt)
    for lanes in (1, 4) if B <= 64 else (1,):
        assert tmb.bucket_plan(ops, N, window, teams_res, lanes=lanes).lanes == lanes
    bads = ({"segs": 0}, {"segs": top + 1}, {"wpt": 0}, {"wpt": D + 1}, {"lanes": 2})
    for bad in bads + (({"lanes": 4},) if B > 64 else ()):
        with pytest.raises(ValueError):
            tmb.bucket_plan(ops, N, window, teams_res, **bad)


def test_fold_rounds():
    """bucket_fold's chain in team rounds: at P-256 w = 5 and one segment,
    30 running-sum steps of 2 adds (5 rounds each) a window a team, once
    or twice (two passes), and the four-group Horner (12 steps of 5
    doublings and an add, 3 of 65 doublings and an add); at Tom-256 w = 6
    and 16 segments, 3 steps, a 6-bit multiple and a 4-level tree (3
    rounds each) before its Horner."""
    horner = 12 * 25 + 3 * (65 * 4 + 5)
    for wpt in (1, 2):
        p_plan = tmb.bucket_plan(tcurve.p256_ops, 256, 5, 0, segs=1, wpt=wpt)
        assert p_plan.groups == 4
        assert tmb.fold_rounds(tcurve.p256_ops, 5, p_plan) == wpt * 2 * 30 * 5 + horner
    t_plan = tmb.bucket_plan(tcurve.tom_ops, 16, 6, 0, segs=16, wpt=1)
    Lg = -(-43 // t_plan.groups)
    horner = (Lg - 1) * (6 * 3 + 3) + (t_plan.groups - 1) * (6 * Lg * 3 + 3)
    assert tmb.fold_rounds(tcurve.tom_ops, 6, t_plan) == 2 * 3 * 3 + (5 * 6 + 3) + 4 * 3 + horner


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
def test_ladder_edge_rows_match_reference(name):
    """The plain ``msm_ladder`` on its edge rows, stacked as the rows of
    one call (the JAX side compiles once): every bit zero (the identity),
    every bit one, the identity point as a term with every bit one; the
    reference's canonical projective coordinates exactly, and the host
    sums."""
    ops, jops, g = CURVES[name]
    R, T = 3, 4
    pts, scs, bits = ladder_edge_rows(g, np.random.RandomState(16), R, T)
    P = ops.pack_points(pts).reshape(R, T, ops.NCOORD, -1)
    jP = jnp.asarray(jops.pack_points(pts))
    got = tcurve.msm_ladder(ops, P, torch.from_numpy(bits))
    ref = jops.msm_ladder(jP.reshape((R, T) + jP.shape[1:]), jnp.asarray(bits))
    assert _port_coords(ops, got) == _coords(jops, ref)
    assert bool(ops.is_identity(got[0]))
    host = ops.unpack_points(got)
    for r in range(R):
        row = pts[r * T : (r + 1) * T]
        assert host[r].eq(_host_sum(g, row, [s % g.order for s in scs[r]]))


@pytest.mark.parametrize("name", list(CURVES))
def test_ladder_edge_rows_one_term_match_host(name):
    """The plain ``msm_ladder`` at T = 1 (the kernel's tree has one term,
    no add) on the edge rows: each row the host's scalar multiple of its
    one point; the all-zero row and the identity point give the
    identity."""
    ops, _, g = CURVES[name]
    R, T = 4, 1
    pts, scs, bits = ladder_edge_rows(g, np.random.RandomState(17), R, T)
    got = ops.unpack_points(tcurve.msm_ladder(ops, ops.pack_points(pts).reshape(R, T, ops.NCOORD, -1),
                                              torch.from_numpy(bits)))
    for r in range(R):
        assert got[r].eq(pts[r].mul(g.new_scalar(scs[r][0] % g.order)))
    assert got[0].is_identity() and got[2].is_identity()


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
