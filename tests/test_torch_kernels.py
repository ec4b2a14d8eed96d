"""The port's kernel wrappers, without the JAX package: this file imports
only PyTorch and ``zkecdsa_tpu_torch``, so it also runs on a machine that
has a card and no JAX.

The ``cuda`` tests hold each CUDA kernel against its plain PyTorch version
on the card (exact: canonical integers) and skip without one.  On such a
machine, from the repository root:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels.py

(``--noconftest``: the suite's conftest sets up JAX.)  The other tests run
the wrappers' CPU path against Python integers and the host curves;
tests/test_torch_curve.py and tests/test_torch_field.py hold the prover's
plain versions against the JAX package and the host curves.
"""

import numpy as np
import pytest
import torch

from zkecdsa_tpu_torch.curves.instances import p256, tomEdwards256
from zkecdsa_tpu_torch.ops import curve_ops as tcurve
from zkecdsa_tpu_torch.ops import field as tf
from zkecdsa_tpu_torch.protocol.batch import DeviceParams
from zkecdsa_tpu_torch.utils import rng as trng
from zkecdsa_tpu_torch.zkp_attest_list import generate_params_list

# One intra-op thread: the suite runs several worker processes on the same
# cores, and an oversubscribed OpenMP pool spins instead of working.
torch.set_num_threads(1)

FIELDS = [tf.P256_P, tf.P256_N, tf.TOM_P, tf.TOM_N, tf.WAR_P]
NL = tf.NLIMBS
CURVES = [(tcurve.p256_ops, p256), (tcurve.tom_ops, tomEdwards256)]


@pytest.fixture(autouse=True)
def port_rng():
    with trng.deterministic(0xC0FFEE):
        yield


@pytest.fixture
def cuda():
    """A CUDA device, decided when the test runs (never at import)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc: the CUDA kernels run only on the card")
    return torch.device("cuda")


def _values(p: int, rs: np.random.RandomState, n: int) -> list[int]:
    edge = [0, 1, p - 1, p - 2, ((1 << p.bit_length()) - 1) % p]
    return edge + [int.from_bytes(rs.bytes(40), "little") % p for _ in range(n - len(edge))]


def _edge_pairs(g, rs, n):
    """n random pairs, then identity + P, P + P, P + (-P), identity + identity."""
    G = g.generator()
    pts = [G.mul(g.new_scalar(int.from_bytes(rs.bytes(32), "little") % g.order)) for _ in range(2 * n)]
    P, Q = pts[:n], pts[n:]
    ident = g.identity()
    return P + [ident, P[0], P[1], ident], Q + [P[2], P[0], P[1].neg(), ident]


@pytest.fixture(scope="module")
def tables():
    """The Tom-256 comb tables of one parameter set (built only where the
    kernels run)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc: the CUDA kernels run only on the card")
    with trng.deterministic(31):
        params = generate_params_list()
    return DeviceParams(params, "cpu").tabs()["gh_t8"]


@pytest.mark.parametrize("f", FIELDS, ids=lambda f: f.name)
def test_field_mul_broadcasts(f):
    """A [9] constant against a [B, 9] batch, both forms, on CPU tensors."""
    rs = np.random.RandomState(1)
    a_i = _values(f.p, rs, 12)
    c = int.from_bytes(rs.bytes(40), "little") % f.p
    a, k = f.pack(a_i), f.const(c)
    assert f.unpack(tf.field_mul(f, a, k)) == [x * c % f.p for x in a_i]
    assert f.unpack(tf.field_mul(f, k, a, a, a)) == [(c * x + x * x) % f.p for x in a_i]


@pytest.mark.parametrize("ops,g", CURVES, ids=lambda v: getattr(v, "name", ""))
def test_straus_msm_edge_rows(ops, g):
    """Rows of identity points and zero scalars give the identity; an
    empty term axis gives the identity too."""
    rs = np.random.RandomState(2)
    P, Q = _edge_pairs(g, rs, 3)
    pts = torch.stack([ops.pack_points(P), ops.pack_points(Q)])
    dig = torch.from_numpy(rs.randint(0, 16, size=(2, len(P), 64)).astype(np.uint8))
    dig[1] = 0
    out = tcurve.straus_msm(ops, pts, dig)
    want = g.identity()
    for p, d in zip(P, dig[0].tolist()):
        want = want.add(p.mul(g.new_scalar(int("".join("%x" % x for x in d), 16))))
    assert ops.unpack_points(out[:1])[0].eq(want)
    assert bool(ops.is_identity(out[1]))
    empty = tcurve.straus_msm(ops, pts[:, :0], dig[:, :0])
    assert ops.is_identity(empty).all()


# the verifier's straus_msm shapes: vphase's window muls, the per-row P-256
# MSM, the combined Tom-256 MSM, path B's one-row MSMs; then small ones
PLAN_SHAPES = [
    (tcurve.p256_ops, 5376, 1), (tcurve.p256_ops, 256, 48), (tcurve.tom_ops, 16, 8192),
    (tcurve.p256_ops, 1, 43), (tcurve.tom_ops, 1, 52), (tcurve.tom_ops, 1, 380),
    (tcurve.p256_ops, 3, 5), (tcurve.tom_ops, 40000, 3),
]


# one-warp blocks of the kernel an SM holds, by coordinates per point (the
# occupancy of ptxas' sm_90a registers: 163 for P-256, 124 for Tom-256)
RESIDENT_WARPS = {3: 12, 4: 16}


@pytest.mark.parametrize("sms", [132, 114], ids=["h100_sxm", "h100_pcie"])
@pytest.mark.parametrize("ops,R,T", PLAN_SHAPES, ids=lambda v: getattr(v, "curve_id", v))
def test_straus_plan(ops, R, T, sms):
    """The launch geometry covers every term exactly once, with at least
    one term a team; its teams fill the card (a few warps an SM) where R*T
    allows and fit the resident warps once; a row of up to 64 chunks folds
    in one block."""
    resident = sms * RESIDENT_WARPS[ops.NCOORD] * 8
    plan = tcurve.straus_plan(R, T, resident)
    assert plan.chunk >= 1
    assert (plan.nchunks - 1) * plan.chunk < T <= plan.nchunks * plan.chunk
    covered = np.zeros(T, dtype=np.int64)
    for c in range(plan.nchunks):
        covered[c * plan.chunk : min(T, (c + 1) * plan.chunk)] += 1
    assert (covered == 1).all()
    assert (plan.nparts - 1) * plan.group < plan.nchunks <= plan.nparts * plan.group
    assert plan.nparts == 1 or plan.group == 64
    assert plan.rows_per_block * plan.group <= 64
    assert plan.rows_per_block == 1 or plan.rows_per_block * plan.group * 4 <= 32  # parts share a warp
    teams = R * plan.nchunks
    assert teams >= min(R * T, resident // 2)  # a few warps an SM where R*T allows
    # one wave of resident warps, or one team a row where the rows alone exceed it
    assert plan.chunk == 1 or teams <= max(R, resident)


# comb_mixed's rows at the main path's calls: vphase [256, 20, 2], phase A
# [256, 162], phase B [10240, 34], GK [12288]; then one row
COMB_ROWS = [256 * 20 * 2, 256 * 162, 10240 * 34, 12288, 1]

# warps of the one-lane comb_mixed kernel an SM holds (the occupancy of
# ptxas' sm_90a registers: 96, five blocks of four warps)
COMB_RESIDENT_WARPS = 20


@pytest.mark.parametrize("sms", [132, 114], ids=["h100_sxm", "h100_pcie"])
@pytest.mark.parametrize("B", COMB_ROWS)
def test_comb_plan(B, sms):
    """Every row in exactly one block; a team of four a row where the rows,
    one lane each, leave the card under-filled (the vphase, phase A, GK
    calls and one row), one lane a row where they fill it several times
    (phase B); the keyword forces either geometry."""
    resident = sms * COMB_RESIDENT_WARPS * 32
    plan = tcurve.comb_plan(B, resident)
    assert plan.lanes == (4 if B < resident else 1)
    assert plan.lanes == (1 if B == 10240 * 34 else 4)
    for lanes in (1, 4):
        forced = tcurve.comb_plan(B, resident, lanes)
        assert forced.lanes == lanes and forced.rows_per_block * lanes == 128
        assert (forced.blocks - 1) * forced.rows_per_block < B <= forced.blocks * forced.rows_per_block
    with pytest.raises(ValueError):
        tcurve.comb_plan(B, resident, 2)


# comb_weier's and mul_comb4's rows: phase A's one comb_weier call [256,
# 81], mul_comb4 [256, 80], the [256] call comb_weier made before the two
# merged; one row; then four times the rows the card holds
WEIER_ROWS = {"hc": 256, "mul_comb4": 20480, "comb_weier": 20736, "one": 1, "fill": None}

# warps of each one-lane kernel an SM holds (the occupancy of ptxas'
# sm_90a registers: comb_weier 136, mul_comb4 138, three blocks of four
# warps)
WEIER_RESIDENT_WARPS = {"comb_weier": 12, "mul_comb4": 12}


@pytest.mark.parametrize("sms", [132, 114], ids=["h100_sxm", "h100_pcie"])
@pytest.mark.parametrize("rows", list(WEIER_ROWS))
@pytest.mark.parametrize("kernel", list(WEIER_RESIDENT_WARPS))
def test_weier_comb_plan(kernel, rows, sms):
    """comb_plan for the P-256 comb kernels, with each kernel's resident
    rows: a team of four a row at every call of the main path and at one
    row, one lane a row where the rows fill the card several times over;
    the keyword forces either geometry; every row in exactly one block."""
    resident = sms * WEIER_RESIDENT_WARPS[kernel] * 32
    B = WEIER_ROWS[rows] or 4 * resident
    plan = tcurve.comb_plan(B, resident)
    assert plan.lanes == (1 if rows == "fill" else 4)
    assert plan.rows_per_block * plan.lanes == 128
    for lanes in (1, 4):
        forced = tcurve.comb_plan(B, resident, lanes)
        assert forced.lanes == lanes
        assert (forced.blocks - 1) * forced.rows_per_block < B <= forced.blocks * forced.rows_per_block


def test_comb_weier_takes_only_both_forms():
    """A bare table never reaches comb_weier's kernel, on any device: the
    wrapper takes a WeierComb or raises."""
    tab = torch.zeros((32, 256, 3, NL), dtype=torch.int32)
    d8 = torch.zeros((2, 32), dtype=torch.uint8)
    for bare in (tab, tab.to("meta"), tcurve.MixedComb(tab, tab)):
        with pytest.raises(TypeError, match="WeierComb"):
            tcurve.comb_weier(bare, d8.to(bare.device) if isinstance(bare, torch.Tensor) else d8)


# to_affine's points at the main path's calls: the verifier's [256, 20, 2],
# the prover's P-256 [256, 163] and [10240], Tom-256 [256, 162], [10240, 39]
# and [12288]; then small ones
AFFINE_POINTS = [10240, 41728, 41472, 399360, 12288, 1, 7, 100000]


@pytest.mark.parametrize("sms", [132, 114], ids=["h100_sxm", "h100_pcie"])
@pytest.mark.parametrize("B", AFFINE_POINTS)
def test_affine_plan(B, sms):
    """Every point in exactly one group, each group at most ``group``
    points: a point a thread while B fits the threads, else the smallest
    group that fits; the keyword forces the group size."""
    threads = sms * 4 * 32  # affine_threads: a warp a scheduler
    plan = tcurve.affine_plan(B, threads)
    assert plan.threads <= max(threads, 1)
    assert plan.group == (1 if B <= threads else -(-B // threads))
    assert plan.group == 1 or -(-B // (plan.group - 1)) > threads  # the smallest that fits
    for g in (1, 3, 16, plan.group):
        forced = tcurve.affine_plan(B, threads, g)
        assert forced.group == g and forced.threads == -(-B // g)
        # thread t takes the points t, t + threads, ...: each once, at most g a thread
        sizes = [len(range(t, B, forced.threads)) for t in range(forced.threads)]
        assert sum(sizes) == B and max(sizes) <= g
    with pytest.raises(ValueError):
        tcurve.affine_plan(B, threads, 0)


@pytest.mark.cuda
@pytest.mark.parametrize("f", FIELDS, ids=lambda f: f.name)
def test_field_mul_kernel_vs_plain(f, cuda):
    rs = np.random.RandomState(3)
    a = f.pack(_values(f.p, rs, 4096), cuda)
    b = f.pack(_values(f.p, rs, 4096)[::-1], cuda)
    assert torch.equal(tf.field_mul(f, a, b), tf.field_mul_plain(f, a, b))
    assert torch.equal(tf.field_mul(f, a, b, b, a), tf.field_mul_plain(f, a, b, b, a))
    torch.cuda.synchronize()


@pytest.mark.parametrize("D", [0, 1, 2, 5])
def test_field_sum_plain_vs_integers(D):
    """The plain version on CPU tensors: the sum over the leading axis."""
    f = tf.TOM_N
    rs = np.random.RandomState(40 + D)
    R = 7
    x_i = _values(f.p, rs, D * R) if D else []
    got = tf.field_sum(f, f.pack(x_i).reshape(D, R, tf.NLIMBS))
    assert f.unpack(got) == [sum(x_i[d * R + r] for d in range(D)) % f.p for r in range(R)]


@pytest.mark.cuda
@pytest.mark.parametrize("D", [1, 2, 8, 2048])
@pytest.mark.parametrize("f", FIELDS, ids=lambda f: f.name)
def test_field_sum_kernel_vs_plain(f, D, cuda):
    """Ragged row counts around the kernel's rows per block (256 / lanes)."""
    rs = np.random.RandomState(41)
    for R in (1, 3, 129):
        x = f.pack(_values(f.p, rs, max(D * R, 5))[: D * R], cuda).reshape(D, R, -1)
        x[-1, 0] = f.const(f.p - 1, cuda)
        assert torch.equal(tf.field_sum(f, x), tf.field_sum_plain(f, x))
    torch.cuda.synchronize()


# rows a field kernel's call gives it: the mesh's [128] (recombine), [1536]
# (d-values), [2048] (sharded_gk_total's chain), the row phase 3 times, one
FIELD_ROWS = [128, 1536, 2048, 65536, 1]


@pytest.mark.parametrize("sms", [132, 114], ids=["h100_sxm", "h100_pcie"])
@pytest.mark.parametrize("rows", FIELD_ROWS)
def test_field_plan(rows, sms):
    """A thread a row: the largest block of 256, 128 or 64 threads that
    gives every SM two blocks, else 32, so the mesh's calls spread over 4
    to 64 SMs; field_sum past 8 terms a row: a block of 32-512 lanes a
    row, about 4 terms a lane."""
    plan = tf.field_plan(rows, sms)
    assert plan.lanes == 1 and plan.threads in (32, 64, 128, 256)
    blocks = -(-rows // plan.threads)
    assert blocks >= 2 * sms or plan.threads == 32
    assert plan.threads == 256 or -(-rows // (2 * plan.threads)) < 2 * sms  # the largest that does
    assert plan.threads == {128: 32, 1536: 32, 2048: 32, 65536: 128 if sms == 132 else 256, 1: 32}[rows]
    for D in (0, 1, 2, 8):
        assert tf.field_plan(rows, sms, D) == plan
    for D, lanes in ((9, 32), (128, 32), (129, 64), (1024, 256), (2048, 512), (1 << 20, 512)):
        assert tf.field_plan(rows, sms, D) == tf.FieldPlan(threads=lanes, lanes=lanes)


@pytest.mark.parametrize("f", FIELDS, ids=lambda f: f.name)
def test_field_mul_chain_plain_vs_integers(f):
    """The chain form on CPU tensors (its plain version): values times n
    factors a row, n = 0 (the values), 1 and 5, edge values included."""
    rs = np.random.RandomState(17)
    R = 6
    v_i = _values(f.p, rs, R)
    for n in (0, 1, 5):
        f_i = _values(f.p, rs, max(R * n, 5))[: R * n][::-1]
        fac = f.pack(f_i).reshape(R, n, NL)
        want = []
        for r in range(R):
            acc = v_i[r]
            for j in range(n):
                acc = acc * f_i[r * n + j] % f.p
            want.append(acc)
        assert f.unpack(tf.field_mul_chain(f, f.pack(v_i), fac)) == want


@pytest.mark.cuda
@pytest.mark.parametrize("f", [tf.P256_P, tf.TOM_N], ids=lambda f: f.name)
def test_field_mul_solinas_edges(f, cuda):
    """The Solinas product on the edge pairs whose reductions take every
    correction (tests/torch_field_edges.py), at the mesh's row counts,
    plain and pair form, against the plain version and Python integers."""
    from torch_field_edges import SOLINAS_EDGE

    rs = np.random.RandomState(5)
    p = f.p
    for B in (128, 1536, 65536):
        pairs = SOLINAS_EDGE + [tuple(int.from_bytes(rs.bytes(40), "little") % p for _ in range(2))
                                for _ in range(B - len(SOLINAS_EDGE))]
        a, b = f.pack([x for x, _ in pairs], cuda), f.pack([y for _, y in pairs], cuda)
        got = tf.field_mul(f, a, b)
        assert torch.equal(got, tf.field_mul_plain(f, a, b))
        assert f.unpack(got[: len(SOLINAS_EDGE)]) == [x * y % p for x, y in SOLINAS_EDGE]
        d, e = b.roll(1, 0), a.roll(3, 0)
        pair = tf.field_mul(f, a, b, d, e)
        assert torch.equal(pair, tf.field_mul_plain(f, a, b, d, e))
        ints = [f.unpack(t[:64]) for t in (a, b, d, e)]
        assert f.unpack(pair[:64]) == [(w * x + y * z) % p for w, x, y, z in zip(*ints)]
    top = f.pack([p - 1] * 4, cuda)  # 2 (p-1)^2 > 2^512: the pair sum's carry word is 1
    assert f.unpack(tf.field_mul(f, top, top, top, top)) == [2 % p] * 4
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("f", FIELDS, ids=lambda f: f.name)
def test_field_mul_grid_shapes(f, cuda):
    """The 2-D grid: [N, K] calls with a broadcast (stride-0) operand, K
    below and above a block, and 70000 rows of K = 1, past the grid's
    65535 in y (the kernel's row stride)."""
    rs = np.random.RandomState(6)
    for N, K in ((3, 1), (256, 7), (5, 300), (70000, 1)):
        a = f.pack(_values(f.p, rs, max(N * K, 5))[: N * K], cuda).reshape(N, K, NL)
        b = f.pack(_values(f.p, rs, max(K, 5))[:K][::-1], cuda).reshape(1, K, NL).expand(N, K, NL)
        assert torch.equal(tf.field_mul(f, a, b), tf.field_mul_plain(f, a, b))
        assert torch.equal(tf.field_mul(f, b, a, a, b), tf.field_mul_plain(f, b, a, a, b))
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("f", FIELDS, ids=lambda f: f.name)
def test_field_mul_chain_kernel_vs_plain(f, cuda):
    """One chain launch against its plain version (a loop of field_mul)
    at sharded_gk_total's [2048] x 12, at one row, a block plus one, and
    n = 0, 1; one field_mul launch each."""
    rs = np.random.RandomState(7)
    for R, n in ((2048, 12), (1, 12), (33, 1), (129, 0), (64, 3)):
        vals = f.pack(_values(f.p, rs, max(R, 5))[:R], cuda)
        fac = f.pack(_values(f.p, rs, max(R * n, 5))[: R * n][::-1], cuda).reshape(R, n, NL)
        before = tf.field_mul.launches
        got = tf.field_mul_chain(f, vals, fac)
        assert tf.field_mul.launches == before + 1
        assert torch.equal(got, tf.field_mul_chain_plain(f, vals, fac))
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("f", [tf.P256_P, tf.TOM_N, tf.TOM_P], ids=lambda f: f.name)
def test_field_sum_caller_shapes(f, cuda):
    """field_sum at the mesh's calls, [2, 1536], [2, 128], [2048, 1] and
    [2, 1], both geometries' edges (8 and 9 terms) and D = 0 (zeros); the
    first row sums p-1 D times (the unreduced P-256 sum's carry word)."""
    rs = np.random.RandomState(8)
    for D, R in ((2, 1536), (2, 128), (2048, 1), (2, 1), (8, 5), (9, 5), (0, 4)):
        x = f.pack(_values(f.p, rs, max(D * R, 5))[: D * R], cuda).reshape(D, R, NL)
        if D:
            x[:, 0] = f.const(f.p - 1, cuda)
        got = tf.field_sum(f, x)
        assert torch.equal(got, tf.field_sum_plain(f, x))
        assert f.unpack(got[:1]) == [(f.p - 1) * D % f.p]
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_noop_launches(cuda):
    """zk_noop, the launch floor's empty kernel, launches at several grids."""
    from zkecdsa_tpu_torch import _build

    lib = _build.load()
    for blocks, threads in ((1, 32), (48, 32), (512, 128)):
        _build.check(lib.zk_noop(blocks, threads, torch.cuda.current_stream().cuda_stream), "zk_noop")
    torch.cuda.synchronize()


def test_build_lock_excludes_a_second_process(monkeypatch, tmp_path):
    """While one process holds the build lock, another's non-blocking
    acquire of the same lock file fails; once released, it succeeds."""
    import subprocess
    import sys

    from zkecdsa_tpu_torch import _build

    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    probe = (
        "import fcntl, os, sys\n"
        "fd = os.open(sys.argv[1], os.O_RDWR)\n"
        "try:\n"
        "    fcntl.flock(fd, fcntl.LOCK_EX | fcntl.LOCK_NB)\n"
        "    print('acquired')\n"
        "except BlockingIOError:\n"
        "    print('busy')\n"
    )
    lock = str(tmp_path / _build.LOCK_NAME)

    def other():
        return subprocess.run([sys.executable, "-c", probe, lock], capture_output=True, text=True,
                              timeout=60, check=True).stdout.strip()

    with _build.build_lock():
        assert other() == "busy"
    assert other() == "acquired"


@pytest.mark.cuda
def test_nccl_refuses_two_ranks_on_one_card(cuda):
    """``backend="nccl"`` with two ranks on one card raises NCCL's error;
    nothing falls back to gloo."""
    import torch_mesh_ranks

    from zkecdsa_tpu_torch.parallel import launch

    with pytest.raises(RuntimeError, match="Duplicate GPU|ncclInvalidUsage"):
        launch.run(torch_mesh_ranks.nccl_pair_on_one_card, 2, backend="nccl", timeout=120)


def _ring_fold_inputs(rs, n, N, cuda):
    f = tf.TOM_N
    vals = f.pack(_values(f.p, rs, max(1 << n, 5))[: 1 << n], cuda)
    fs = f.pack(_values(f.p, rs, max(N * n, 5))[: N * n], cuda).reshape(N, n, tf.NLIMBS)
    xf = f.pack(_values(f.p, rs, max(N * n, 5))[: N * n][::-1], cuda).reshape(N, n, tf.NLIMBS)
    return vals, fs, xf


@pytest.mark.cuda
@pytest.mark.parametrize("n", range(13))
def test_ring_fold_kernel_vs_plain(n, cuda):
    """Every ring size up to 2^12: a block of 2^n threads with one value
    each up to n = 8, then 256 threads folding 2^(n-8) values each before
    the block's tree (the geometry depends on n alone; a block a row), on
    a few rows and on 300 (more blocks than SMs)."""
    rs = np.random.RandomState(4 + n)
    for N in (1, 3, 300):
        vals, fs, xf = _ring_fold_inputs(rs, n, N, cuda)
        assert torch.equal(tf.ring_fold(vals, fs, xf), tf.ring_fold_plain(vals, fs, xf))
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_ring_fold_kernel_mesh_slice(cuda):
    """The ring-sharded GK routines' call: a slice of the ring and the low
    bits of f, xf only (non-contiguous views), as parallel/mesh.py makes."""
    rs = np.random.RandomState(5)
    vals, fs, xf = _ring_fold_inputs(rs, 12, 7, cuda)
    half, lo = vals[2048:], slice(0, 11)
    got = tf.ring_fold(half, fs[:, lo], xf[:, lo])
    assert torch.equal(got, tf.ring_fold_plain(half, fs[:, lo], xf[:, lo]))
    torch.cuda.synchronize()


def _affine_batch(ops, rs, B, cuda):
    """B points of random canonical coordinates (to_affine is field
    arithmetic: they need not lie on the curve)."""
    f = ops.f
    return f.pack(_values(f.p, rs, max(B * ops.NCOORD, 5))[: B * ops.NCOORD], cuda).reshape(
        B, ops.NCOORD, NL
    )


def _zero_z(ops, P, idx):
    """Point(s) idx with Z = 0: the P-256 identity (0:1:0); on Tom-256 a
    zero Z that no curve point has, which the kernel still flags."""
    if ops is tcurve.p256_ops:
        P[idx] = ops.identity((), P.device)
    else:
        P[idx, -1] = 0


def _affine_equal_plain(ops, P, group):
    got = tcurve.to_affine(ops, P, group=group)
    want = ops.to_affine(P)
    return all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.cuda
@pytest.mark.parametrize("g", [1, 4, 16])
@pytest.mark.parametrize("ops,g_", CURVES, ids=lambda v: getattr(v, "name", ""))
def test_to_affine_groups(ops, g_, g, cuda):
    """Groups of g points forced on 1, g - 1, g, g + 1 and 5g points with
    zero Z in them; a group of zero Z only; a zero Z at every position of
    one group; bit for bit against the plain version."""
    rs = np.random.RandomState(130 + g)
    for B in sorted({1, max(1, g - 1), g, g + 1, 5 * g}):
        P = _affine_batch(ops, rs, B, cuda)
        _zero_z(ops, P, B // 2)
        assert _affine_equal_plain(ops, P, g)
    B = 5 * g
    T = tcurve.affine_plan(B, 1, g).threads
    P = _affine_batch(ops, rs, B, cuda)
    _zero_z(ops, P, torch.arange(2, B, T, device=cuda))  # thread 2's whole group
    x, y, inf = tcurve.to_affine(ops, P, group=g)
    assert bool(inf[2::T].all()) and not bool(inf[3::T].any())
    assert _affine_equal_plain(ops, P, g)
    for k in range(g):  # thread 2 restored; a zero Z at position k of thread 1's group
        Q = P.clone()
        Q[2::T] = _affine_batch(ops, rs, len(range(2, B, T)), cuda)
        _zero_z(ops, Q, 1 + k * T)
        assert _affine_equal_plain(ops, Q, g)
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("ops,g", CURVES, ids=lambda v: getattr(v, "name", ""))
def test_point_kernels_vs_plain(ops, g, cuda):
    rs = np.random.RandomState(61)
    P_h, Q_h = _edge_pairs(g, rs, 60)
    P, Q = ops.pack_points(P_h, cuda), ops.pack_points(Q_h, cuda)
    assert torch.equal(tcurve.ec_add(ops, P, Q), ops.add(P, Q))
    for a, b in zip(tcurve.to_affine(ops, P), ops.to_affine(P)):
        assert torch.equal(a, b)
    pts = torch.stack([P, Q])
    dig = torch.from_numpy(rs.randint(0, 16, size=(2, P.shape[0], 64)).astype(np.uint8)).to(cuda)
    got, plain = tcurve.straus_msm(ops, pts, dig), ops.msm_shared(pts, dig)
    # the kernel adds in another order: compare the affine points
    for a, b in zip(ops.to_affine(got), ops.to_affine(plain)):
        assert torch.equal(a, b)
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 7, 8, 9, 257])
@pytest.mark.parametrize("ops,g", CURVES, ids=lambda v: getattr(v, "name", ""))
def test_window_table_kernel_vs_plain(ops, g, B, cuda):
    """One window_table launch against ops.table, bit for bit: one point,
    a block of 8 teams minus one, a block, a block plus one and 32 blocks
    plus one, with the identity as an input point where there are two or
    more (its table is 16 identities)."""
    rs = np.random.RandomState(110 + B)
    pts = [g.generator().mul(g.new_scalar(_scalar(g, rs))) for _ in range(B)]
    if B > 1:
        pts[B // 2] = g.identity()
    P = ops.pack_points(pts, cuda)
    before = tcurve.window_table.launches
    tab = tcurve.window_table(ops, P)
    assert tcurve.window_table.launches == before + 1
    assert torch.equal(tab, ops.table(P))
    assert ops.is_identity(tab[B // 2]).all() == (B > 1)
    # batch dims beyond one
    assert torch.equal(tcurve.window_table(ops, P[None]), tab[None])
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_ec_add_merged_rows(cuda):
    """Phase A's comS1 = sR + Hc and D = Q + (-sR) as one [N, 2] ec_add
    launch equal the two [N] launches it replaced and the plain version."""
    rs = np.random.RandomState(111)
    ops, g, N = tcurve.p256_ops, p256, 13
    sR, Hc, Q = (
        ops.pack_points([g.generator().mul(g.new_scalar(_scalar(g, rs))) for _ in range(N)], cuda)
        for _ in range(3)
    )
    Q[0] = sR[0]  # D = the identity
    P2, Q2 = torch.stack([sR, Q], dim=1), torch.stack([Hc, ops.neg(sR)], dim=1)
    cd = tcurve.ec_add(ops, P2, Q2)
    assert torch.equal(cd[:, 0], tcurve.ec_add(ops, sR, Hc))
    assert torch.equal(cd[:, 1], tcurve.ec_add(ops, Q, ops.neg(sR)))
    assert torch.equal(cd, ops.add(P2, Q2))
    assert bool(ops.is_identity(cd[0, 1]))
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_comb_mixed_kernel_vs_plain(tables, cuda):
    tabs = tables.to(cuda)
    d8 = torch.from_numpy(np.random.RandomState(71).randint(0, 256, size=(64, 64)).astype(np.uint8))
    d8[0] = 0
    d8 = d8.to(cuda)
    got = tcurve.comb_mixed(tabs, d8)
    assert torch.equal(got, tcurve.tom_ops.mul_comb_mixed(tabs.canon, d8))
    assert bool(tcurve.tom_ops.is_identity(got[0]))
    # digits that do not start on 16 bytes (the kernel's loads) are copied
    shifted = torch.empty(64 * 64 + 8, dtype=torch.uint8, device=cuda)[8:].view(64, 64)
    shifted.copy_(d8)
    assert torch.equal(tcurve.comb_mixed(tabs, shifted), got)
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 5, 33, 129])
@pytest.mark.parametrize("lanes", [1, 4], ids=["lane", "team"])
def test_comb_mixed_geometries(tables, lanes, B, cuda):
    """Both geometries, forced, on ragged row counts (one row, a few, a
    team block plus one, a lane block plus one) with an all-zero row,
    bit for bit against the plain version."""
    tabs = tables.to(cuda)
    d8 = torch.from_numpy(np.random.RandomState(72 + B).randint(0, 256, size=(B, 64)).astype(np.uint8))
    d8[B // 2] = 0
    d8 = d8.to(cuda)
    got = tcurve.comb_mixed(tabs, d8, lanes=lanes)
    assert torch.equal(got, tcurve.tom_ops.mul_comb_mixed(tabs.canon, d8))
    assert bool(tcurve.tom_ops.is_identity(got[B // 2]))
    torch.cuda.synchronize()


@pytest.fixture(scope="module")
def prover_tables():
    """The prover's device tables (built only where the kernels run)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc: the CUDA kernels run only on the card")
    with trng.deterministic(32):
        params = generate_params_list()
    return DeviceParams(params, "cpu").tabs()


def _scalar(g, rs) -> int:
    return int.from_bytes(rs.bytes(32), "little") % g.order


@pytest.mark.cuda
def test_shamir_kernel_vs_plain(prover_tables, cuda):
    tabs = prover_tables
    rs = np.random.RandomState(91)
    ops, g = tcurve.p256_ops, p256
    pts = ops.pack_points([g.generator().mul(g.new_scalar(_scalar(g, rs))) for _ in range(40)], cuda)
    tab = tcurve.window_table(ops, pts)
    assert torch.equal(tab, ops.table(pts))
    dP = torch.from_numpy(rs.randint(0, 16, size=(40, 2, 64)).astype(np.uint8)).to(cuda)
    dQ = torch.from_numpy(rs.randint(0, 16, size=(40, 2, 64)).astype(np.uint8)).to(cuda)
    dQ[:, 1] = 0
    tp = torch.stack([tab, tabs["G"].to(cuda).expand_as(tab)], dim=1)
    # a second shared table, of another base than G
    hn = ops.table(ops.pack_points([g.generator().mul(g.new_scalar(_scalar(g, rs)))], cuda))[0]
    got = tcurve.shamir(tp, dP, hn, dQ)
    assert torch.equal(got, ops.double_mul_tables(tp, dP, hn, dQ))
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_shamir_kernel_ragged_rows(prover_tables, cuda):
    """13 rows (not a multiple of the 8 teams of a block): a shared table
    against per-row ones, then the [N, 2] broadcast of phase A with a
    shared table and zero digits on the other side, bit for bit."""
    tabs = prover_tables
    rs = np.random.RandomState(90)
    ops, g = tcurve.p256_ops, p256
    n = 13
    pts = ops.pack_points([g.generator().mul(g.new_scalar(_scalar(g, rs))) for _ in range(n)], cuda)
    tab = ops.table(pts)
    G = tabs["G"].to(cuda)
    d1 = torch.from_numpy(rs.randint(0, 16, size=(n, 64)).astype(np.uint8)).to(cuda)
    d2 = torch.from_numpy(rs.randint(0, 16, size=(n, 64)).astype(np.uint8)).to(cuda)
    d1[0] = 0
    assert torch.equal(tcurve.shamir(G, d1, tab, d2), ops.double_mul_tables(G, d1, tab, d2))
    tp = torch.stack([tab, G.expand_as(tab)], dim=1)
    dP = torch.from_numpy(rs.randint(0, 16, size=(n, 2, 64)).astype(np.uint8)).to(cuda)
    dQ = torch.zeros_like(dP)
    got = tcurve.shamir(tp, dP, G, dQ)
    assert torch.equal(got, ops.double_mul_tables(tp, dP, G, dQ))
    torch.cuda.synchronize()


def _straus_case(ops, g, rs, R, T, cuda):
    """R rows of T terms on the card with identity points and zero digits
    in them, the kernel against ops.msm_shared as affine points."""
    pts = [g.generator().mul(g.new_scalar(_scalar(g, rs))) for _ in range(R * T)]
    P = ops.pack_points(pts, cuda).reshape(R, T, ops.NCOORD, -1)
    P[0, -1] = ops.identity((), cuda)
    dig = torch.from_numpy(rs.randint(0, 16, size=(R, T, 64)).astype(np.uint8)).to(cuda)
    dig[-1, 0] = 0
    dig[0, :, :5] = 0
    return _affine_equal(ops, tcurve.straus_msm(ops, P, dig), ops.msm_shared(P, dig))


@pytest.mark.cuda
@pytest.mark.parametrize("ops,g", CURVES, ids=lambda v: getattr(v, "name", ""))
def test_straus_msm_one_term_rows(ops, g, cuda):
    """T = 1, vphase's form: many one-term rows, eight parts to a block."""
    assert _straus_case(ops, g, np.random.RandomState(81), 300, 1, cuda)
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("T", [43, 130])
@pytest.mark.parametrize("ops,g", CURVES, ids=lambda v: getattr(v, "name", ""))
def test_straus_msm_one_row(ops, g, T, cuda):
    """R = 1, path B's form: one row folded in its block (43 terms) or in
    three parts summed by ec_add (130 terms)."""
    assert tcurve.straus_plan(1, T, tcurve.straus_teams(ops, cuda)).nparts == -(-T // 64)
    assert _straus_case(ops, g, np.random.RandomState(82), 1, T, cuda)
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("ops,g", CURVES, ids=lambda v: getattr(v, "name", ""))
def test_straus_msm_ragged_chunks(ops, g, cuda):
    """Enough rows that a team takes two terms, and T = 3 not a multiple
    of the chunk."""
    R, T = tcurve.straus_teams(ops, cuda) // 2, 3
    plan = tcurve.straus_plan(R, T, tcurve.straus_teams(ops, cuda))
    assert plan.chunk == 2 and T % plan.chunk
    rs = np.random.RandomState(83)
    host = [g.generator().mul(g.new_scalar(_scalar(g, rs))) for _ in range(64)]
    P = ops.pack_points(host, cuda)[torch.from_numpy(rs.randint(0, 64, size=R * T))]
    P = P.reshape(R, T, ops.NCOORD, -1)
    P[0, -1] = ops.identity((), cuda)
    dig = torch.from_numpy(rs.randint(0, 16, size=(R, T, 64)).astype(np.uint8)).to(cuda)
    dig[1] = 0
    assert _affine_equal(ops, tcurve.straus_msm(ops, P, dig), ops.msm_shared(P, dig))
    torch.cuda.synchronize()


def _zero_rows(B: int, lanes) -> list[int]:
    """Rows given all-zero digits: the first, the last of the first block
    (a team's last row there) and the last (the row an idle team past B
    runs)."""
    blk = 128 // (lanes or 4)
    return sorted({0, min(blk, B) - 1, B - 1})


# (lanes, rows) of the P-256 comb kernels' cases: the plan's geometry,
# then each forced one at one row, a block minus one, a block, a block
# plus one and five blocks (a block: 32 rows of a team, 128 of a lane)
WEIER_CASES = [(None, 54)] + [
    (lanes, b) for lanes in (1, 4) for blk in (128 // lanes,) for b in (1, blk - 1, blk, blk + 1, 5 * blk)
]


@pytest.mark.cuda
@pytest.mark.parametrize("lanes,B", WEIER_CASES)
def test_comb4_kernels_vs_plain(lanes, B, cuda):
    """The bases and both forms of the entries against the plain versions
    (the Montgomery form converted back, and the canonical option), then
    mul_comb4 on the Montgomery tables under the geometry, bit for bit
    against the plain version on the canonical ones: B scalars over R
    bases (R = 6 for the plan's case, else 5 for five blocks, 1 or 2)."""
    rs = np.random.RandomState(92 + B)
    ops, g = tcurve.p256_ops, p256
    R = 6 if lanes is None else 5 if B % 5 == 0 else 2 if B % 2 == 0 else 1
    S = B // R
    P = ops.pack_points([g.generator().mul(g.new_scalar(_scalar(g, rs))) for _ in range(R)], cuda)
    bases = tcurve.comb4_bases(P)
    assert torch.equal(bases, ops.comb4_bases(P))
    plain = ops.comb4_entries(bases)
    tab = tcurve.comb4_entries(bases)
    assert torch.equal(ops.f.from_mont(tab), plain)
    assert torch.equal(tcurve.comb4_entries(bases, canon=True), plain)
    assert torch.equal(tcurve.comb4_table(P), tab)
    assert torch.equal(tcurve.comb4_table(P, canon=True), ops.comb4_table(P))
    dig = torch.from_numpy(rs.randint(0, 16, size=(R * S, 64)).astype(np.uint8))
    zero = _zero_rows(R * S, lanes)
    dig[zero] = 0
    dig = dig.reshape(R, S, 64).to(cuda)
    got = tcurve.mul_comb4(tab, dig, lanes=lanes)
    assert torch.equal(got, ops.mul_comb4(plain, dig))
    assert ops.is_identity(got.reshape(-1, 3, NL)[zero]).all()
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("R", [1, 9, 33, 256])
def test_comb4_bases_ragged(R, cuda):
    """A team per base, 8 to a block: one base, a block plus one, four
    blocks plus one and the prover's 256, bit for bit against the plain
    version; then comb4_entries on those bases (a team per (base,
    position) row, 8 rows to a block) in both forms, with an identity base
    among them where there are two or more."""
    rs = np.random.RandomState(100 + R)
    ops, g = tcurve.p256_ops, p256
    pts = [g.generator().mul(g.new_scalar(_scalar(g, rs))) for _ in range(R)]
    if R > 1:
        pts[R // 2] = g.identity()
    P = ops.pack_points(pts, cuda)
    bases = tcurve.comb4_bases(P)
    assert torch.equal(bases, ops.comb4_bases(P))
    plain = ops.comb4_entries(bases)
    assert torch.equal(ops.f.from_mont(tcurve.comb4_entries(bases)), plain)
    assert torch.equal(tcurve.comb4_entries(bases, canon=True), plain)
    assert ops.is_identity(plain[R // 2]).all() == (R > 1)
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("R", [1, 2, 3])
@pytest.mark.parametrize("ops,g", CURVES, ids=lambda v: getattr(v, "name", ""))
def test_comb8_bases_kernel_vs_plain(ops, g, R, cuda):
    """A team per base, LSB-first windows: one base (P-256 h), two (the
    Tom-256 g and h), three; bit for bit against the plain version."""
    rs = np.random.RandomState(110 + R)
    P = ops.pack_points([g.generator().mul(g.new_scalar(_scalar(g, rs))) for _ in range(R)], cuda)
    got = tcurve.comb8_bases(ops, P)
    assert torch.equal(got, ops.comb8_bases(P))
    assert ops.unpack_points(got[0, 1:2])[0].eq(ops.unpack_points(P[:1])[0].mul(g.new_scalar(256)))
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("ops,g", CURVES, ids=lambda v: getattr(v, "name", ""))
def test_comb8_entries_kernel_vs_plain(ops, g, cuda):
    """The tables of two bases from their window bases, bit for bit
    against the plain version (both forms for Tom-256), and the wrapper
    pair against the Python-integer host oracle."""
    rs = np.random.RandomState(120)
    pts = [g.generator().mul(g.new_scalar(_scalar(g, rs))) for _ in range(2)]
    bases = ops.comb8_bases(ops.pack_points(pts, cuda))
    got = tcurve.comb8_entries(ops, bases)
    want = ops.comb8_entries(bases)
    if ops is tcurve.p256_ops:
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        host = DeviceParams._host_comb_weier(pts[0])
        comb = tcurve.comb_table(ops.pack_points(pts[:1], cuda)[0])
        assert torch.equal(comb.canon.cpu(), host)
        assert torch.equal(comb.mont.cpu(), ops.f.pack_mont(ops.f.unpack(host)).reshape(host.shape))
    else:
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        host = tcurve.MixedComb.pack(DeviceParams._host_comb_mixed(pts[0]) + DeviceParams._host_comb_mixed(pts[1]))
        comb = tcurve.comb_table_mixed(ops.pack_points(pts, cuda))
        assert torch.equal(comb.canon.cpu(), host.canon) and torch.equal(comb.mont.cpu(), host.mont)
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("ops,g", CURVES, ids=lambda v: getattr(v, "name", ""))
def test_comb8_entries_identity_base(ops, g, cuda):
    """Three bases, the identity in the middle (every Z of its P-256 windows
    zero: the inversion tree takes one for each and sets its inverse to
    0), from the kernel's window bases: both kernels bit for bit against
    their plain versions, in both forms; the identity's entries are (0, 1,
    0) at P-256 and the mixed rows of (0, 1), (0, 1, 1, 0, 0), at Tom-256."""
    rs = np.random.RandomState(121)
    pts = [g.generator().mul(g.new_scalar(_scalar(g, rs))), g.identity(),
           g.generator().mul(g.new_scalar(_scalar(g, rs)))]
    P = ops.pack_points(pts, cuda)
    bases = tcurve.comb8_bases(ops, P)
    assert torch.equal(bases, ops.comb8_bases(P))
    got = tcurve.comb8_entries(ops, bases)
    want = ops.comb8_entries(bases)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    rows = [0, 1, 0] if ops is tcurve.p256_ops else [0, 1, 1, 0, 0]
    assert torch.equal(got[0][1].cpu(), ops.f.pack(rows).expand(32, 256, len(rows), NL))
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("lanes,B", WEIER_CASES)
def test_comb_weier_kernel_vs_plain(prover_tables, lanes, B, cuda):
    """comb_weier on the Montgomery table under the geometry, bit for bit
    against the plain version on the canonical one; the plan's case as
    phase A shapes it, [N, 81] rows; the bare table raises."""
    comb = prover_tables["comb_h_n8"].to(cuda)
    d8 = torch.from_numpy(np.random.RandomState(93 + B).randint(0, 256, size=(B, 32)).astype(np.uint8))
    zero = _zero_rows(B, lanes)
    d8[zero] = 0
    d8 = d8.to(cuda)
    if lanes is None:
        d8 = d8.reshape(-1, 27, 32)  # [2, 27] rows, as phase A's [N, 81]
    got = tcurve.comb_weier(comb, d8, lanes=lanes)
    assert torch.equal(got, tcurve.p256_ops.mul_comb(comb.canon, d8))
    assert tcurve.p256_ops.is_identity(got.reshape(-1, 3, NL)[zero]).all()
    with pytest.raises(TypeError):
        tcurve.comb_weier(comb.mont, d8)
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_chord_kernel_vs_plain(cuda):
    """The fused chord kernel (T1 projective in, one inverse a row)
    against its plain version (to_affine, then the chord pass), bit for
    bit, with rows where T1 is the identity (Z = 0), where i7 = pkx - t1x
    = 0, and both; 300 rows: a ragged last block."""
    f, ops, g = tf.TOM_N, tcurve.p256_ops, p256
    rs = np.random.RandomState(94)
    K = 300
    pts = [g.generator().mul(g.new_scalar(_scalar(g, rs))) for _ in range(K)]
    lam = [int.from_bytes(rs.bytes(40), "little") % (f.p - 1) + 1 for _ in range(K)]
    T1 = f.pack([c * l % f.p for pt, l in zip(pts, lam) for c in ops._host_coords(pt)], cuda).reshape(K, 3, NL)
    x = f.pack(_values(f.p, rs, K * 13), cuda).reshape(K, 13, NL)
    T1[1] = T1[3] = ops.identity((), cuda)  # Z = 0
    t1x, _, _ = ops.to_affine(T1)
    x[2, 0] = t1x[2]  # i7 = 0
    x[3, 0] = 0  # T1 the identity and i7 = 0
    before = tcurve.chord.launches
    got = tcurve.chord(T1, x)
    assert tcurve.chord.launches == before + 1
    assert torch.equal(got, tcurve.chord_plain(T1, x))
    assert f.unpack(got[1, :2]) == [0, 0]
    assert f.unpack(got[2, 2:4]) == [0, 0] and f.unpack(got[3, :4]) == [0] * 4
    assert f.unpack(got[1, 2:4]) == [f.unpack(x[1, 0])[0], pow(f.unpack(x[1, 0])[0], f.p - 2, f.p)]
    torch.cuda.synchronize()


# ec_add's calls in one prove: phase A's [256, 2] (comS1, D) and [256, 80]
# (A), phase B's [10240] (T1), Tom-256 [10240, 5] and [10240] (cintX); the
# verifier's [256, 20] (vphase T1)
EC_ADD_SHAPES = [
    (tcurve.p256_ops, (256, 2)), (tcurve.p256_ops, (256, 80)), (tcurve.p256_ops, (10240,)),
    (tcurve.tom_ops, (10240, 5)), (tcurve.tom_ops, (10240,)), (tcurve.p256_ops, (256, 20)),
]


@pytest.mark.cuda
@pytest.mark.parametrize("ops,shape", EC_ADD_SHAPES, ids=lambda v: getattr(v, "curve_id", v))
def test_ec_add_call_shapes(ops, shape, cuda):
    """ec_add (a team of four lanes a pair) at each call shape of a prove
    and of a verify, bit for bit against ops.add; rows of identity + P,
    P + P, P + (-P) and identity + identity at the head."""
    g = p256 if ops is tcurve.p256_ops else tomEdwards256
    rs = np.random.RandomState(112)
    P_h, Q_h = _edge_pairs(g, rs, 60)
    B = int(np.prod(shape))
    idx = torch.arange(B) % len(P_h)
    P = ops.pack_points(P_h, cuda)[idx].reshape(shape + (ops.NCOORD, NL))
    Q = ops.pack_points(Q_h, cuda)[(idx * 7 + 3) % len(Q_h)].reshape(shape + (ops.NCOORD, NL))
    flat_P, flat_Q = P.view(-1, ops.NCOORD, NL), Q.view(-1, ops.NCOORD, NL)
    flat_P[:4], flat_Q[:4] = ops.pack_points(P_h[-4:], cuda), ops.pack_points(Q_h[-4:], cuda)
    before = tcurve.ec_add.launches
    got = tcurve.ec_add(ops, P, Q)
    assert tcurve.ec_add.launches == before + 1
    assert torch.equal(got, ops.add(P, Q))
    assert ops.is_identity(got.view(-1, ops.NCOORD, NL)[2:4]).all()
    torch.cuda.synchronize()


def _ec_add_levels(ops, P):
    """The design tree_sum replaced: the plain tree's levels as one
    ec_add launch each."""
    while P.shape[0] > 1:
        h = P.shape[0] // 2
        P = torch.cat([tcurve.ec_add(ops, P[:h], P[h : 2 * h]), P[2 * h :]], dim=0)
    return P[0]


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 2, 3, 12, 16, 64, 65, 130])
@pytest.mark.parametrize("ops,g", CURVES, ids=lambda v: getattr(v, "name", ""))
def test_tree_sum_kernel_vs_levels(ops, g, n, cuda):
    """tree_sum over [n, 3] points (three columns, an identity among them)
    against the plain version and the ec_add level loop it replaced, bit
    for bit: one launch up to the shared-memory cap of 64 points (none for
    one point), one launch a level past it until the column fits."""
    rs = np.random.RandomState(113 + n)
    pool = ops.pack_points([g.generator().mul(g.new_scalar(_scalar(g, rs))) for _ in range(31)] + [g.identity()], cuda)
    P = pool[torch.from_numpy(rs.randint(0, 32, size=(n, 3))).to(cuda)]
    P[0, 1] = ops.identity((), cuda)
    before, before_add = tcurve.tree_sum.launches, tcurve.ec_add.launches
    got = tcurve.sum_reduce(ops, P, axis=0)
    levels, m = 0, n
    while m > 64:
        levels, m = levels + 1, m // 2 + m % 2
    assert tcurve.tree_sum.launches == before + (1 if n > 1 else 0)
    assert tcurve.ec_add.launches == before_add + levels
    assert torch.equal(got, ops.sum_reduce(P))
    assert torch.equal(got, _ec_add_levels(ops, P))
    assert torch.equal(tcurve.sum_reduce(ops, P.transpose(0, 1).contiguous(), axis=1), got)
    torch.cuda.synchronize()


def _affine_equal(ops, a, b) -> bool:
    """Two batches of points are the same group elements: the kernels and
    the plain versions may add in other orders, so their projective
    coordinates differ; the canonical affine ones may not."""
    return all(torch.equal(x, y) for x, y in zip(ops.to_affine(a), ops.to_affine(b)))


def _msm_rows(g, rs, N, T):
    """N rows of T random points and scalars, with the edge scalars 0, 1,
    order - 1, a duplicate, and an identity point with scalar 0 at the
    end of each row."""
    G = g.generator()
    pts = [G.mul(g.new_scalar(_scalar(g, rs))) for _ in range(N * T)]
    scs = [[_scalar(g, rs) for _ in range(T)] for _ in range(N)]
    for i in range(N):
        scs[i][:4] = [0, 1, g.order - 1, scs[i][4]]
        pts[i * T + T - 1], scs[i][T - 1] = g.identity(), 0
    return pts, scs


@pytest.mark.cuda
@pytest.mark.parametrize("ops,g", CURVES, ids=lambda v: getattr(v, "name", ""))
def test_msm_ladder_edge_rows(ops, g, cuda):
    """msm_ladder on the edge rows (every bit zero, every bit one, the
    identity point as a term) at a ragged [3, 37], whose last block holds
    idle teams, and at T = 1: exactly the plain version, the same group
    elements as straus_msm, the all-zero row the identity; one launch a
    call; bits whose rows start off a 16-byte boundary give the same
    result."""
    from torch_ladder_edges import ladder_edge_rows

    rs = np.random.RandomState(98)
    for R, T in ((3, 37), (4, 1)):
        pts, scs, bits = ladder_edge_rows(g, rs, R, T)
        P = ops.pack_points(pts, cuda).reshape(R, T, ops.NCOORD, -1)
        b = torch.from_numpy(bits).to(cuda)
        before = tcurve.msm_ladder.launches
        got = tcurve.msm_ladder(ops, P, b)
        assert tcurve.msm_ladder.launches == before + 1
        assert torch.equal(got, ops.msm_ladder(P, b))
        assert bool(ops.is_identity(got[0]))
        flat = [s for row in scs for s in row]
        digits = torch.from_numpy(tcurve.nibble_digits(flat).astype(np.uint8).reshape(R, T, 64)).to(cuda)
        assert _affine_equal(ops, got, tcurve.straus_msm(ops, P, digits))
        off = torch.empty(b.numel() + 1, dtype=torch.uint8, device=cuda)[1:].view(b.shape).copy_(b)
        assert off.data_ptr() % 16 != 0
        assert torch.equal(tcurve.msm_ladder(ops, P, off), got)
    torch.cuda.synchronize()


def _bucket_case(g, rs, case, window):
    """(points, scalar rows) of one bucket-kernel case; points cycle
    through a pool of 16 host points (the large cases stay quick)."""
    from zkecdsa_tpu_torch.ops import msm_bucket as tmb

    N, T = {"random": (3, 200), "one_bucket": (2, 100), "top_window": (2, 96), "one_term": (3, 1),
            "ragged": (5, 37), "identity": (2, 40), "window7": (1, 8193)}[case]
    G = g.generator()
    pool = [G.mul(g.new_scalar(_scalar(g, rs))) for _ in range(16)]
    pts = [pool[rs.randint(16)] for _ in range(N * T)]
    scs = [[_scalar(g, rs) for _ in range(T)] for _ in range(N)]
    D = tmb.n_windows(window)
    if case == "random":
        for i in range(N):
            scs[i][:4] = [0, 1, g.order - 1, scs[i][4 % T]]
            pts[i * T + T - 1], scs[i][T - 1] = g.identity(), 0
        scs[2] = [0] * T  # a row of padding: every bucket empty
    elif case == "one_bucket":  # every term of a window in one bucket
        scs = [[scs[i][0]] * T for i in range(N)]
    elif case == "top_window":  # only the top window's digits are nonzero
        top = 256 - (D - 1) * window
        scs = [[int(rs.randint(1, 1 << top)) << ((D - 1) * window) for _ in range(T)] for _ in range(N)]
    elif case == "identity":  # identity points, and a row of them only
        pts = [g.identity() if (k % 3 == 0 or k < T) else p for k, p in enumerate(pts)]
    return pts, scs


# (window, case): each case at w = 5 and 6, and T = 8193 at w = 7 (pick_window)
BUCKET_CASES = [(w, c) for c in ("random", "one_bucket", "top_window", "one_term", "ragged", "identity")
                for w in (5, 6)] + [(7, "window7")]


@pytest.mark.cuda
@pytest.mark.parametrize("window,case", BUCKET_CASES, ids=lambda v: str(v))
@pytest.mark.parametrize("ops,g", CURVES, ids=lambda v: getattr(v, "name", ""))
def test_bucket_kernels_vs_plain(ops, g, window, case, cuda):
    """Both bucket kernels against their plain versions as group elements,
    on the plan's geometry and on every forced one: a lane and a team a
    bucket (a team up to 64 buckets), 1, 2, 3, 4 and B - 1 (at most 32)
    segments a window, so that segments of one bucket and counts that do
    not divide B - 1 are run, and 1, 2, 3 and D windows a team; the two
    together against straus_msm."""
    from zkecdsa_tpu_torch.ops import msm_bucket as tmb

    rs = np.random.RandomState(95 + window)
    pts, scs = _bucket_case(g, rs, case, window)
    N, T = len(scs), len(scs[0])
    if case == "window7":
        assert tmb.pick_window(T) == window
    P = ops.pack_points(pts, cuda).reshape(N, T, ops.NCOORD, -1)
    dig = torch.from_numpy(tmb.window_digits(scs, T, window)).to(cuda)
    B = 1 << window
    S_plain = tmb.bucket_sums_plain(ops, P, dig, window)
    S = tmb.bucket_sums(ops, P, dig, window)
    assert _affine_equal(ops, S, S_plain)
    for lanes in (1, 4) if B <= 64 else (1,):
        assert _affine_equal(ops, tmb.bucket_sums(ops, P, dig, window, lanes=lanes), S_plain)
    if B > 64:
        with pytest.raises(ValueError):
            tmb.bucket_sums(ops, P, dig, window, lanes=4)
    want = tmb.bucket_fold_plain(ops, S_plain, window)
    out = tmb.bucket_fold(ops, S, window)
    assert _affine_equal(ops, out, want)
    for segs in sorted({1, 2, 3, 4, min(32, B - 1)}):
        assert _affine_equal(ops, tmb.bucket_fold(ops, S, window, segs=segs), want)
    for wpt in (1, 2, 3, tmb.n_windows(window)):
        assert _affine_equal(ops, tmb.bucket_fold(ops, S, window, segs=1, wpt=wpt), want)
    assert torch.equal(tmb.msm_bucket_rows(ops, P, scs, window), out)
    digits = torch.from_numpy(tcurve.nibble_digits([s for row in scs for s in row]).astype(np.uint8))
    straus = tcurve.straus_msm(ops, P, digits.reshape(N, T, 64).to(cuda))
    assert _affine_equal(ops, out, straus)
    if case == "random":
        assert bool(ops.is_identity(out[2]))
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("ops,g", CURVES, ids=lambda v: getattr(v, "name", ""))
def test_msm_ladder_and_msm_vs_plain(ops, g, cuda):
    rs = np.random.RandomState(97)
    N, T = 2, 40
    pts, scs = _msm_rows(g, rs, N, T)
    P = ops.pack_points(pts, cuda).reshape(N, T, ops.NCOORD, -1)
    flat = [s for row in scs for s in row]
    bits = torch.from_numpy(tcurve.scalar_bits(flat).reshape(N, T, 256)).to(cuda)
    got = tcurve.msm_ladder(ops, P, bits)
    # a team of four lanes a term in the plain version's order, then its tree
    assert torch.equal(got, ops.msm_ladder(P, bits))
    digits = torch.from_numpy(tcurve.nibble_digits(flat).astype(np.uint8).reshape(N, T, 64)).to(cuda)
    assert _affine_equal(ops, got, tcurve.straus_msm(ops, P, digits))
    one = tcurve.msm(ops, P[0], digits[0])
    assert _affine_equal(ops, one, ops.msm(P[0], digits[0]))
    assert _affine_equal(ops, one, got[0])
    torch.cuda.synchronize()
