"""The port's mesh (``zkecdsa_tpu_torch.parallel``) against the JAX
package's ``parallel/mesh.py``, on the CPU.

The JAX side runs in this process on the conftest's 8 virtual CPU devices.
The port's side runs as ranks spawned by ``parallel.launch`` on gloo with
``device="cpu"`` (the rank functions live in ``tests/torch_mesh_ranks.py``,
which imports no JAX): one 4-rank world for the ``dp`` and ``ring``
meshes.  tests/test_torch_mesh_pipeline.py holds the 2 x 4 mesh and the
sharded pipeline.  Inputs are made from numpy
seeds, the shapes those of tests/test_mesh.py; comparisons are exact, on
canonical integers or affine coordinates.
"""

import importlib.util
import time
import types
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_mesh_ranks as ranks
from zkecdsa_tpu.curves.instances import tomEdwards256 as jtom
from zkecdsa_tpu.ops.curve_ops import nibble_digits as jnibbles
from zkecdsa_tpu.ops.curve_ops import tom_ops as jtom_ops
from zkecdsa_tpu.ops.f32field import TOM_N as JTOM_N
from zkecdsa_tpu.parallel import mesh as jmesh
from zkecdsa_tpu.protocol.batch import device_params_for as jdevice_params_for
from zkecdsa_tpu.serde import write_json as jwrite_json
from zkecdsa_tpu.utils import rng as jrng
from zkecdsa_tpu.zkp_attest_list import SystemParametersList as JParams
from zkecdsa_tpu.zkp_attest_list import generate_params_list as jgenerate_params
from zkecdsa_tpu_torch import carry
from zkecdsa_tpu_torch import entry as tentry
from zkecdsa_tpu_torch.ops import curve_ops as tcurve
from zkecdsa_tpu_torch.ops import field as tf
from zkecdsa_tpu_torch.parallel import launch
from zkecdsa_tpu_torch.protocol.batch import BatchProver
from zkecdsa_tpu_torch.protocol.batch_verify import BatchVerifier
from zkecdsa_tpu_torch.serde import write_json
from zkecdsa_tpu_torch.zkp_attest_list import SystemParametersList

# One intra-op thread: the suite runs several worker processes on the same
# cores, and an oversubscribed OpenMP pool spins instead of working.
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
fo = JTOM_N
TIMEOUT = 300  # seconds for a world of ranks to finish


def _ints(rs, n, bits):
    return [int(rs.randint(1, 1 << bits)) for _ in range(n)]


def _jax_affine(arr):
    return [pt.to_affine() for pt in jtom_ops.unpack_points(np.asarray(arr))]


@pytest.fixture(scope="module")
def jparams():
    with jrng.deterministic(31337):
        return jgenerate_params()


@pytest.fixture(scope="module")
def case4():
    rs = np.random.RandomState(3)
    vals, blinds = _ints(rs, 8, 60), _ints(rs, 8, 60)
    rs = np.random.RandomState(4)
    RING, n = 8, 3
    factors, vec = _ints(rs, RING * n, 50), _ints(rs, RING, 50)
    rs = np.random.RandomState(5)
    mult = [k + 2 for k in range(RING)]
    scalars = _ints(rs, RING, 40)
    return {
        "vals": vals, "blinds": blinds, "ring_n": (RING, n), "factors": factors, "vec": vec,
        "msm_points": mult, "msm_scalars": scalars,
        "msm_digits": tcurve.nibble_digits(scalars).astype(np.uint8).tolist(),
    }


@pytest.fixture(scope="module")
def four(jparams, case4):
    """The 4-rank world's results, by rank."""
    return launch.run(ranks.four, 4, args=(jwrite_json(JParams, jparams), case4), timeout=TIMEOUT)


def test_launch_fails_fast_when_a_rank_raises():
    """A rank that raises fails the run with its traceback; the rank left
    waiting in a collective is terminated, long before the deadline."""
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="rank 1 raised:(.|\n)*fails on purpose"):
        launch.run(ranks.second_raises, 2, timeout=TIMEOUT)
    assert time.monotonic() - t0 < TIMEOUT / 2


def test_shard_batch_requires_divisibility(four):
    for rank, out in enumerate(four):
        assert "not divisible" in out["odd_batch"]
        assert out["slice"] == [2 * rank, 2 * rank + 1]
        assert out["none_is_noop"]


def test_replicate_places_every_leaf(four):
    for out in four:
        assert out["leaves"] == [("a", "cpu", "Tensor"), ("b", "cpu", "Tensor")]
        assert out["replicate_none_is_noop"]


@pytest.mark.parametrize("D", [1, 2, 5])
def test_field_sum_plain_matches_jax_fold(D):
    """field_sum's plain version against a fold of the reference's
    TOM_N.add over the leading axis."""
    rs = np.random.RandomState(10 + D)
    R = 3
    x_i = [int.from_bytes(rs.bytes(40), "little") % fo.p for _ in range(D * R)]
    x = jnp.asarray(fo.pack(x_i)).reshape(D, R, -1)
    acc = x[0]
    for d in range(1, D):
        acc = fo.add(acc, x[d])
    got = tf.field_sum(tf.TOM_N, tf.TOM_N.pack(x_i).reshape(D, R, -1))
    assert tf.TOM_N.unpack(got) == fo.unpack(np.asarray(acc))


def test_sharded_commit_matches_jax(jparams, case4, four):
    mesh = jmesh.make_mesh(8)
    out = jmesh.sharded_commit(
        mesh, jdevice_params_for(jparams),
        jmesh.shard_batch(mesh, jnp.asarray(fo.pack(case4["vals"]))),
        jmesh.shard_batch(mesh, jnp.asarray(fo.pack(case4["blinds"]))),
    )
    want = _jax_affine(out)
    for r in four:
        assert r["commit"] == want


def test_sharded_gk_total_matches_jax(case4, four):
    RING, n = case4["ring_n"]
    factors = jnp.asarray(fo.pack(case4["factors"])).reshape(RING, n, -1)
    total = jmesh.sharded_gk_total(jmesh.make_mesh(8, axis="ring"), factors, jnp.asarray(fo.pack(case4["vec"])))
    want = fo.unpack(np.asarray(total).reshape(1, -1))[0]
    assert [r["gk_total"] for r in four] == [want] * 4


def test_sharded_msm_matches_jax(case4, four):
    pts = [jtom.generator().mul(jtom.new_scalar(k)) for k in case4["msm_points"]]
    out = jmesh.sharded_msm(
        jmesh.make_mesh(8, axis="ring"), jtom_ops,
        jnp.asarray(jtom_ops.pack_points(pts)), jnp.asarray(jnibbles(case4["msm_scalars"])),
    )
    want = _jax_affine(np.asarray(out)[None])[0]
    assert [r["msm"] for r in four] == [want] * 4


def test_entry_matches_jax_entry():
    """The forward step of ``zkecdsa_tpu_torch.entry`` against the one of
    ``__graft_entry__.entry``: the same 8 commitments."""
    spec = importlib.util.spec_from_file_location("graft_entry", ROOT / "__graft_entry__.py")
    jentry = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jentry)
    assert write_json(SystemParametersList, tentry._params()) == jwrite_json(JParams, jentry._params())
    jforward, jargs = jentry.entry()
    forward, args = tentry.entry(device="cpu")
    assert [tf.TOM_N.unpack(a) for a in args] == [fo.unpack(np.asarray(a)) for a in jargs]
    got = [pt.to_affine() for pt in tcurve.tom_ops.unpack_points(forward(*args))]
    assert got == _jax_affine(jforward(*jargs))


def test_entry_points_check_the_mesh():
    """A mesh without ``dp``, a device other than the mesh's, and a
    sharded prove without tapes are refused before any collective (a
    mesh's shape and device are all these checks read)."""
    with jrng.deterministic(5):
        params = carry.params_from_jax(jwrite_json(JParams, jgenerate_params()))
    cpu = torch.device("cpu")
    ring_only = types.SimpleNamespace(shape={"ring": 2}, device=cpu)
    dp = types.SimpleNamespace(shape={"dp": 1}, device=cpu)
    for cls in (BatchProver, BatchVerifier):
        with pytest.raises(ValueError, match="'dp' mesh axis"):
            cls(params, mesh=ring_only)
        with pytest.raises(ValueError, match="not the mesh's device"):
            cls(params, device="meta", mesh=dp)
        assert cls(params, device="cpu", mesh=dp).device == cpu
    with pytest.raises(ValueError, match="pass the tapes"):
        BatchProver(params, mesh=dp).prove([b"m"], [b"s"], [b"p"], [0], [1, 2])
