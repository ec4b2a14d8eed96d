"""The port's mesh pipeline on the CPU: the d-value and recombination
routines on a 2 dp x 4 ring mesh against the JAX package's, the [N, E]
phase B against the flat one, and ``entry.dryrun_multichip`` - the sharded
``BatchProver``/``BatchVerifier`` on a 2 dp x 2 ring mesh, with the ring
axis engaged - against the unsharded port prover.

The JAX side runs in this process on the conftest's 8 virtual CPU devices;
the port's ranks are spawned by ``parallel.launch`` on gloo with
``device="cpu"`` and one intra-op thread each (rank functions in
``tests/torch_mesh_ranks.py`` and ``zkecdsa_tpu_torch/entry.py``, which
import no JAX).  Comparisons are exact: canonical integers, proof bytes.
"""

import concurrent.futures

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_mesh_ranks as ranks
from zkecdsa_tpu.ops.f32field import TOM_N as JTOM_N
from zkecdsa_tpu.parallel import mesh as jmesh
from zkecdsa_tpu_torch.curves.instances import p256, tomEdwards256
from zkecdsa_tpu_torch.entry import dryrun_inputs, dryrun_multichip
from zkecdsa_tpu_torch.ops import curve_ops as tcurve
from zkecdsa_tpu_torch.ops import field as tf
from zkecdsa_tpu_torch.parallel import launch
from zkecdsa_tpu_torch.protocol import batch as tbatch
from zkecdsa_tpu_torch.protocol.batch_gk import gk_dvalues_device, gk_recombine_device
from zkecdsa_tpu_torch.serde import write_json
from zkecdsa_tpu_torch.utils import rng as trng
from zkecdsa_tpu_torch.zkp_attest_list import SignatureProofList, generate_params_list

# One intra-op thread: the suite runs several worker processes on the same
# cores, and an oversubscribed OpenMP pool spins instead of working.
torch.set_num_threads(1)

fo = JTOM_N
TIMEOUT = 300  # seconds for the 8-rank world
DRYRUN_TIMEOUT = 900  # seconds for the dry run's prove and two verifies


def _ints(rs, n, bits):
    return [int(rs.randint(1, 1 << bits)) for _ in range(n)]


@pytest.fixture(scope="module")
def case8():
    rs = np.random.RandomState(6)
    N, n, RING = 2, 4, 16
    dv = {"shape": (N, n, RING), "eli": rs.randint(0, 2, (N, n)).tolist(),
          "ai": _ints(rs, N * n, 50), "vals": _ints(rs, RING, 50), "vidx": _ints(rs, N, 50)}
    rs = np.random.RandomState(7)
    N, n, RING = 2, 3, 8
    rc = {"shape": (N, n, RING), "f": _ints(rs, N * n, 50), "xf": _ints(rs, N * n, 50),
          "vals": _ints(rs, RING, 50)}
    rs = np.random.RandomState(8)
    N, n, RING = 2, 2, 4
    d1 = {"shape": (N, n, RING), "eli": rs.randint(0, 2, (N, n)).tolist(),
          "ai": _ints(rs, N * n, 50), "vals": _ints(rs, RING, 50), "vidx": _ints(rs, N, 50)}
    return {"dvalues": dv, "recombine": rc, "dvalues_1": d1}


@pytest.fixture(scope="module")
def eight(case8):
    """The 8-rank (2 dp x 4 ring) world's results, by rank."""
    return launch.run(ranks.eight, 8, args=(case8,), timeout=TIMEOUT)


def test_sharded_gk_dvalues_matches_jax(case8, eight):
    dv = case8["dvalues"]
    N, n, RING = dv["shape"]
    args = (
        jnp.asarray(np.asarray(dv["eli"], np.int32)),
        jnp.asarray(fo.pack(dv["ai"])).reshape(N, n, -1),
        jnp.asarray(fo.pack(dv["vals"])),
        jnp.asarray(fo.pack(dv["vidx"])),
    )
    want = fo.unpack_canonical(jmesh.sharded_gk_dvalues(jmesh.make_mesh_2d(2, 4), *args, dp_axis="dp"))
    assert {r["coords"] for r in eight} == {(d, k) for d in range(2) for k in range(4)}
    assert [r["dvalues"] for r in eight] == [want] * 8
    # and the port's unsharded d-values
    ai = [dv["ai"][i * n : (i + 1) * n] for i in range(N)]
    unsharded = gk_dvalues_device(dv["eli"], ai, dv["vals"], dv["vidx"], "cpu")
    assert [d for row in unsharded for d in row] == want


def test_sharded_gk_dvalues_one_ring_element_a_rank(case8, eight):
    """localR = 1: each rank's fold has no low bits, only its coordinate's
    high-bit factors; equal to the port's unsharded d-values."""
    d1 = case8["dvalues_1"]
    N, n, _ = d1["shape"]
    ai = [d1["ai"][i * n : (i + 1) * n] for i in range(N)]
    want = gk_dvalues_device(d1["eli"], ai, d1["vals"], d1["vidx"], "cpu")
    assert [r["dvalues_1"] for r in eight] == [[d for row in want for d in row]] * 8


def test_sharded_gk_recombine_matches_jax(case8, eight):
    rc = case8["recombine"]
    N, n, RING = rc["shape"]
    f = jnp.asarray(fo.pack(rc["f"])).reshape(N, n, -1)
    xf = jnp.asarray(fo.pack(rc["xf"])).reshape(N, n, -1)
    vals = jnp.asarray(fo.pack(rc["vals"]))
    want = fo.unpack_canonical(jmesh.sharded_gk_recombine(jmesh.make_mesh_2d(2, 4), f, xf, vals, dp_axis="dp"))
    assert [r["recombine"] for r in eight] == [want] * 8
    t = tf.TOM_N
    unsharded = gk_recombine_device(
        t.pack(rc["f"]).reshape(N, n, -1), t.pack(rc["xf"]).reshape(N, n, -1), t.pack(rc["vals"])
    )
    assert t.unpack(unsharded) == want


def test_phase_b_matches_phase_b_flat():
    """phase_b on [N, E] rows selected by eidx against phase_b_flat on the
    same rows as a flat srcid axis."""
    with trng.deterministic(8):
        params = generate_params_list()
    tabs = tbatch.DeviceParams(params, "cpu").tabs()
    rs = np.random.RandomState(9)
    N, E, R = 2, 2, tbatch.SECPARAM

    def points(ops, g, *shape):
        host = [g.generator().mul(g.new_scalar(int(rs.randint(2, 1 << 30)))) for _ in range(8)]
        k = int(np.prod(shape))
        return ops.pack_points([host[i % 8] for i in range(k)]).reshape(*shape, ops.NCOORD, -1)

    def scalars(*shape):
        k = int(np.prod(shape))
        return tf.TOM_N.pack([int.from_bytes(rs.bytes(40), "little") for _ in range(k)]).reshape(*shape, -1)

    T, D = points(tcurve.p256_ops, p256, N, R), points(tcurve.p256_ops, p256, N)
    TC = points(tcurve.tom_ops, tomEdwards256, N, R, 2)
    pkC = points(tcurve.tom_ops, tomEdwards256, N, 2)
    common = (tabs, T, D, TC[:, :, 0], TC[:, :, 1], pkC[:, 0], pkC[:, 1], scalars(N, R),
              scalars(N), scalars(N), scalars(N), scalars(N, R))
    com_vals, com_blinds = scalars(N, E, tbatch.BK), scalars(N, E, tbatch.BK)
    eidx = torch.tensor([[3, 7], [0, R - 1]])
    srcid = torch.tensor([3, 7, R, 2 * R - 1])
    b = tbatch.phase_b(*common, com_vals, com_blinds, eidx)
    flat = tbatch.phase_b_flat(*common, com_vals.flatten(0, 1), com_blinds.flatten(0, 1), srcid)
    assert torch.equal(b["ints"].flatten(0, 1), flat["ints"])
    for got, want in zip(b["tom_aff"], flat["tom_aff"]):
        assert got.shape[:2] == (N, E)
        assert torch.equal(got.flatten(0, 1), want)


@pytest.fixture(scope="module")
def pipeline():
    """dryrun_multichip(4) on gloo and the CPU - a 2 dp x 2 ring mesh,
    N=2 proofs at ring 4 - and, meanwhile in this process, the unsharded
    port prover on the same inputs and tapes."""
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        sharded = pool.submit(dryrun_multichip, 4, device="cpu", backend="gloo", timeout=DRYRUN_TIMEOUT)
        params, msgs, sigs, pubs, whichs, ring, seeds = dryrun_inputs(2)
        tapes = [trng.DeterministicSource(s) for s in seeds]
        base = tbatch.BatchProver(params, device="cpu").prove(msgs, sigs, pubs, whichs, ring, tapes)
        return sharded.result(), [write_json(SignatureProofList, p) for p in base]


def test_sharded_pipeline_proofs_equal_unsharded(pipeline):
    reports, base = pipeline
    assert len(reports) == 4
    for r in reports:
        assert r["proofs"] == base


def test_sharded_pipeline_verdicts(pipeline):
    reports, _ = pipeline
    for r in reports:
        assert r["verdicts"] == [True, True]
        assert r["tampered"] == [False, True]


def test_sharded_pipeline_engages_ring_axis(pipeline):
    reports, _ = pipeline
    for r in reports:
        assert r["mesh"] == {"dp": 2, "ring": 2} and r["ring"] == 4
        assert r["ring_sharded"] and r["backend"] == "gloo" and r["device"] == "cpu"
