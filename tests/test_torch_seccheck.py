"""The security gate over the port (``tools/seccheck_torch.py``): zero
findings over the port's files, and each check fires on a file that
breaks it."""

import importlib.util
import subprocess
import sys
from pathlib import Path

import pytest
import torch

# One intra-op thread: the suite runs several worker processes on the same
# cores, and an oversubscribed OpenMP pool spins instead of working.
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location("seccheck_torch", ROOT / "tools" / "seccheck_torch.py")
seccheck = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(seccheck)


def test_gate_reports_no_finding_over_the_port():
    out = subprocess.run([sys.executable, str(ROOT / "tools" / "seccheck_torch.py")], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout[-3000:]
    assert "seccheck: 0 finding(s)" in out.stdout


def test_gate_scans_the_port_and_not_the_jax_package():
    files = {str(Path(p).relative_to(ROOT)) for p in seccheck._iter_py(seccheck.ALL_DIRS)}
    for rel in ("zkecdsa_tpu_torch/entry.py", "zkecdsa_tpu_torch/utils/rng.py", "chip_smoke.py",
                "bench_cuda.py", "bench_components_torch.py", "examples/usage_batched_torch.py",
                "tools/seccheck_torch.py", "tests/test_torch_seccheck.py", "tests/torch_mesh_ranks.py"):
        assert rel in files
    assert not any(f.startswith(("zkecdsa_tpu/", "examples/usage.py", "tools/seccheck.py")) for f in files)


_BAD = {
    "numpy_random": ("import numpy as np\nx = np.random.RandomState(0)\n", "numpy.random in library code"),
    "stdlib_random": ("import random\n", "stdlib `random`"),
    "shell": ("import subprocess\nsubprocess.run('ls', shell=True)\n", "shell=True"),
    "eval": ("eval('1')\n", "call to eval"),
    "pickle": ("import pickle\npickle.loads(b'')\n", "unsafe pickle.loads"),
    "md5": ("import hashlib\nhashlib.md5(b'')\n", "weak hash"),
    "mktemp": ("import tempfile\ntempfile.mktemp()\n", "mktemp"),
}


@pytest.mark.parametrize("case", list(_BAD))
def test_each_check_fires_in_library_code(case, tmp_path):
    src, what = _BAD[case]
    path = tmp_path / "bad.py"
    path.write_text(src)
    assert any(what in f for f in seccheck.scan_file(str(path), in_lib=True))


def test_the_rng_seam_may_draw_randomness():
    seam = ROOT / seccheck.RNG_SEAM
    assert seam.exists() and seccheck.scan_file(str(seam), in_lib=True) == []
