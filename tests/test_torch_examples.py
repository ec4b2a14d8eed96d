"""The port's examples run end to end on the CPU in a fresh interpreter:
``examples/usage_torch.py`` (the host scalar walkthrough, within
``ci.sh``'s 600 s limit for its counterpart) and
``examples/usage_batched_torch.py`` with ``DEVICE=cpu BATCH=1`` (one proof,
a ring of 5 keys, the plain PyTorch versions)."""

import os
import subprocess
import sys
from pathlib import Path

import torch

# One intra-op thread: the suite runs several worker processes on the same
# cores, and an oversubscribed OpenMP pool spins instead of working.
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]


def _run(script: str, timeout: float, **env) -> str:
    out = subprocess.run(
        [sys.executable, str(ROOT / "examples" / script)], cwd=ROOT, timeout=timeout,
        env=dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1", **env),
        capture_output=True, text=True,
    )
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout


def test_usage_torch_walkthrough():
    out = _run("usage_torch.py", 600)
    assert "Valid signature: True" in out


def test_usage_batched_torch_on_the_cpu():
    out = _run("usage_batched_torch.py", 300, DEVICE="cpu", BATCH="1")
    assert "device: cpu  batch: 1  ring: 5" in out
    assert "batched verify:" in out and out.rstrip().endswith("-> [True]")
