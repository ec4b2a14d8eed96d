"""The port stands alone: it imports neither JAX nor the JAX package, its
entry points run on CUDA unless told otherwise, and a tensor that is not on
the CPU never falls back to a plain version."""

import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import torch.distributed as dist

from zkecdsa_tpu_torch import _build
from zkecdsa_tpu_torch import entry as tentry
from zkecdsa_tpu_torch.curves import multimult as tmm
from zkecdsa_tpu_torch.curves.instances import p256
from zkecdsa_tpu_torch.ops import curve_ops as tcurve
from zkecdsa_tpu_torch.ops import field as tf
from zkecdsa_tpu_torch.ops import msm_bucket as tmb
from zkecdsa_tpu_torch.parallel import mesh as tmesh
from zkecdsa_tpu_torch.protocol import batch_gk as tgk
from zkecdsa_tpu_torch.protocol import batch as tbatch
from zkecdsa_tpu_torch.protocol import batch_verify as tbv
from zkecdsa_tpu_torch.protocol import verify as tverify
from zkecdsa_tpu_torch.utils import rng as trng
from zkecdsa_tpu_torch.zkp_attest_list import generate_params_list

# One intra-op thread: the suite runs several worker processes on the same
# cores, and an oversubscribed OpenMP pool spins instead of working.
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]

# The examples, the benchmark entry points, the security gate, the native
# runtime (loaded), the mesh modules and the entry points, a tiny verify (4
# exp rounds, 2 checked, ring of 2) on the Straus and on
# the bucket backend, the scalar verifier on the device MSM backend (20
# rounds, the count it checks), and a tiny batched prove (one proof, ring
# of 2) in a fresh interpreter, then the list of every loaded module that
# belongs to JAX or the JAX package.
_PROBE = r"""
import dataclasses, hashlib, importlib.util, sys
import chip_smoke  # noqa: F401  the chip script's own imports
# the examples, the benchmark entry points and the security gate, loaded
# as modules (their main() not run)
for path in ("examples/usage_torch.py", "examples/usage_batched_torch.py", "bench_cuda.py",
             "bench_components_torch.py", "tools/seccheck_torch.py"):
    spec = importlib.util.spec_from_file_location(path.replace("/", "_")[:-3], path)
    spec.loader.exec_module(importlib.util.module_from_spec(spec))
from zkecdsa_tpu_torch.runtime import native
native.available()  # builds or loads libzkruntime.so
import zkecdsa_tpu_torch.entry  # noqa: F401
import zkecdsa_tpu_torch.parallel  # noqa: F401
import zkecdsa_tpu_torch.parallel.launch  # noqa: F401
from zkecdsa_tpu_torch import ecdsa
from zkecdsa_tpu_torch.protocol.batch import BatchProver
from zkecdsa_tpu_torch.protocol.batch_verify import BatchVerifier
from zkecdsa_tpu_torch.protocol.verify import device_msm_backend
from zkecdsa_tpu_torch.utils import rng
from zkecdsa_tpu_torch.utils.config import get_config, set_config
from zkecdsa_tpu_torch.zkp_attest_list import (
    generate_params_list, prove_signature_list, verify_signature_list,
)
with rng.deterministic(3):
    params = generate_params_list(sec_level=4)
    kp = ecdsa.generate_keypair()
    mh = hashlib.sha256(b"probe").digest()
    sig = ecdsa.sign(kp, b"probe")
    pub = ecdsa.export_public_raw(kp)
    ring = [ecdsa.key_to_int(pub), 5]
    proof = prove_signature_list(params, mh, sig, pub, 0, ring)
    ok = BatchVerifier(params, device="cpu").verify([mh], ring, [proof])
assert ok == [True], ok
set_config(dataclasses.replace(get_config(), pippenger_min_t=32))
with rng.deterministic(3):
    ok = BatchVerifier(params, device="cpu").verify([mh], ring, [proof])
assert ok == [True], ok
set_config(dataclasses.replace(get_config(), pippenger_min_t=0))
with rng.deterministic(5):
    params20 = generate_params_list(sec_level=20)
    proof20 = prove_signature_list(params20, mh, sig, pub, 0, ring)
    with device_msm_backend("cpu"):
        assert verify_signature_list(params20, mh, ring, proof20)
with rng.deterministic(4):
    params80 = generate_params_list()
proofs = BatchProver(params80, device="cpu").prove(
    [mh], [sig], [pub], [0], ring, [rng.DeterministicSource(9)]
)
assert len(proofs) == 1 and len(proofs[0].expProof) == 80
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "jaxlib"))
             or (m.startswith("zkecdsa_tpu") and not m.startswith("zkecdsa_tpu_torch")))
print("FOREIGN", bad)
"""


def test_port_imports_no_jax_and_no_reference():
    env = dict(os.environ, ZKECDSA_VERIFY_ROUNDS="2", PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, "-c", _PROBE], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=600,
    )
    assert out.returncode == 0, out.stderr[-3000:]
    assert "FOREIGN []" in out.stdout, out.stdout


def test_entry_point_defaults_to_cuda(monkeypatch):
    """No device means CUDA; without a card the entry point raises instead
    of running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with trng.deterministic(1):
        params = generate_params_list()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tbv.BatchVerifier(params)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tbv.batch_verify_signature_list(params, [], [1, 2], [])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tbatch.BatchProver(params)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tbatch.batched_prove_signature_list(params, [], [], [], [], [1, 2])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tverify.batched_verify_signature_list(params, [], [1, 2], [])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        with tverify.device_msm_backend():
            pass
    assert tmm._MSM_BACKEND is None
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tverify.device_msm(p256, [p256.generator()], [1])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tgk.batch_verify_membership(params.proof_group, [], [1, 2], [])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tentry.entry()


def test_make_mesh_defaults_to_cuda(monkeypatch):
    """make_mesh() means CUDA: without a card it raises before it starts
    a process group, and never falls back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (tmesh.make_mesh, lambda: tmesh.make_mesh_2d(1, 1)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make()
    assert not dist.is_initialized()


def _meta(shape, dtype=torch.int32):
    return torch.empty(shape, dtype=dtype, device="meta")


# each wrapper, called with tensors that are not on the CPU
_CALLS = {
    "field_mul": lambda: tf.field_mul(tf.P256_P, _meta((4, 9)), _meta((4, 9))),
    "ring_fold": lambda: tf.ring_fold(_meta((4, 9)), _meta((1, 2, 9)), _meta((1, 2, 9))),
    "field_sum": lambda: tf.field_sum(tf.TOM_N, _meta((2, 3, 9))),
    "field_mul_chain": lambda: tf.field_mul_chain(tf.TOM_N, _meta((4, 9)), _meta((4, 3, 9))),
    "ec_add": lambda: tcurve.ec_add(tcurve.p256_ops, _meta((4, 3, 9)), _meta((4, 3, 9))),
    "window_table": lambda: tcurve.window_table(tcurve.p256_ops, _meta((4, 3, 9))),
    "to_affine": lambda: tcurve.to_affine(tcurve.tom_ops, _meta((4, 4, 9))),
    "straus_msm": lambda: tcurve.straus_msm(
        tcurve.p256_ops, _meta((1, 4, 3, 9)), _meta((1, 4, 64), torch.uint8)
    ),
    "comb_mixed": lambda: tcurve.comb_mixed(
        tcurve.MixedComb(_meta((64, 256, 5, 9)), _meta((64, 256, 5, 9))), _meta((2, 64), torch.uint8)
    ),
    "shamir": lambda: tcurve.shamir(
        _meta((16, 3, 9)), _meta((2, 64), torch.uint8), _meta((2, 16, 3, 9)), _meta((2, 64), torch.uint8)
    ),
    "comb4_table": lambda: tcurve.comb4_table(_meta((2, 3, 9))),
    "comb4_bases": lambda: tcurve.comb4_bases(_meta((2, 3, 9))),
    "comb4_entries": lambda: tcurve.comb4_entries(_meta((2, 64, 3, 9))),
    "mul_comb4": lambda: tcurve.mul_comb4(
        _meta((2, 64, 16, 3, 9)), _meta((2, 5, 64), torch.uint8)
    ),
    "comb_weier": lambda: tcurve.comb_weier(
        tcurve.WeierComb(_meta((32, 256, 3, 9)), _meta((32, 256, 3, 9))), _meta((2, 32), torch.uint8)
    ),
    "comb8_bases": lambda: tcurve.comb8_bases(tcurve.tom_ops, _meta((2, 4, 9))),
    "comb8_entries": lambda: tcurve.comb8_entries(tcurve.p256_ops, _meta((1, 32, 3, 9))),
    "comb_table": lambda: tcurve.comb_table(_meta((3, 9))),
    "comb_table_mixed": lambda: tcurve.comb_table_mixed(_meta((2, 4, 9))),
    "DeviceParams": lambda: tbatch.DeviceParams(generate_params_list(), "meta"),
    "chord": lambda: tcurve.chord(_meta((4, 3, 9)), _meta((4, 13, 9))),
    "tree_sum": lambda: tcurve.tree_sum(tcurve.tom_ops, _meta((12, 2, 4, 9))),
    "sum_reduce": lambda: tcurve.sum_reduce(tcurve.p256_ops, _meta((2, 16, 3, 9)), axis=1),
    "bucket_sums": lambda: tmb.bucket_sums(
        tcurve.tom_ops, _meta((2, 8, 4, 9)), _meta((2, 52, 8), torch.uint8), 5
    ),
    "bucket_fold": lambda: tmb.bucket_fold(tcurve.tom_ops, _meta((2, 52, 32, 4, 9)), 5),
    "msm_bucket_rows": lambda: tmb.msm_bucket_rows(tcurve.p256_ops, _meta((1, 3, 3, 9)), [[1, 2, 3]]),
    "msm_ladder": lambda: tcurve.msm_ladder(
        tcurve.p256_ops, _meta((2, 4, 3, 9)), _meta((2, 4, 256), torch.uint8)
    ),
    "msm": lambda: tcurve.msm(tcurve.tom_ops, _meta((4, 4, 9)), _meta((4, 64), torch.uint8)),
    "device_msm": lambda: tverify.device_msm(p256, [p256.generator()], [5], device="meta"),
}


@pytest.mark.parametrize("name", list(_CALLS))
def test_wrapper_without_kernels_raises(name, monkeypatch, tmp_path):
    """A tensor off the CPU goes to the kernel: with no built library and
    no nvcc the wrapper raises, and never takes the plain version."""
    monkeypatch.setattr(_build, "_lib", None)
    monkeypatch.setattr(_build, "LIB_PATH", tmp_path / "missing.so")
    monkeypatch.setattr(_build.shutil, "which", lambda _name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _CALLS[name]()
