"""The harness end to end at a tiny size on the CPU (N = 2, ring 16, the
port's plain versions), through the same code as a run on the card: the
cells come out correct; with the timed path broken underneath they do
not; the controls come out not correct; the command fails without a card;
nothing loads JAX or the JAX package.

On the card, ``python -m pytest -m cuda zkbench/tests`` runs one short
cell of each path through ``zkbench/run.py``.
"""

import json
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from zkbench.harness import cell, manifest  # noqa: E402

SEED = 2**31 + 2**20 + 7  # past 32 signed bits, as a check's seeds may be
TINY = dict(batch=2, pool=4, ring=16, check=4, trace_batches=1, tampered=4, tamper_every=2)


def with_held_cells() -> dict:
    """``BENCHMARK.json`` with the prove and hardened verify cells it holds
    back (PERF.md, Open questions) and their metrics, which its harness
    keeps."""
    man = manifest.load()
    man["configs"].append({"name": "hardened-ring4096", "source": "held back",
                           "file": "zkbench/configs/hardened-ring4096.json", "reduced": ["ring"], "why": "held back"})
    man["workloads"].append({"name": "verify.hardened-ring4096", "config": "hardened-ring4096", "traffic": "verify",
                             "chips": 1, "why": "held back"})
    for m in man["end_to_end"] + man["per_layer"]:
        if "verify.ref-ring4096" in m.get("workloads", ()):
            m["workloads"].append("verify.hardened-ring4096")
    man["workloads"].append({"name": "prove.ref-ring4096", "config": "ref-ring4096", "traffic": "prove",
                             "chips": 1, "why": "held back"})
    man["end_to_end"].append({"name": "prove_proofs_per_s", "unit": "proofs/s", "better": "higher",
                              "bound": 0.25, "source": "host_clock", "workloads": ["prove.ref-ring4096"]})
    for name in ("serde_s", "tape_hash_s", "assembly_s", "device_idle_share", "kernels_roofline", "gc_s"):
        man["per_layer"].append({"name": f"{name}.prove", "unit": "%" if "share" in name or "roofline" in name
                                 else "s", "better": "higher" if "roofline" in name else "lower",
                                 "source": "program_span", "layer": name, "moves": "prove_proofs_per_s",
                                 "workloads": ["prove.ref-ring4096"]})
    return man


HELD = with_held_cells()


@pytest.fixture(autouse=True)
def one_thread():
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tiny_run(workload, trace=False, seconds=0.0):
    return cell.run(workload, SEED, seconds, trace, t_start=time.perf_counter(), device="cpu",
                    overrides=TINY, man=HELD, log=lambda _msg: None)


@pytest.mark.parametrize("workload", ["prove.ref-ring4096", "verify.ref-ring4096", "verify.hardened-ring4096"])
def test_tiny_run_is_correct(workload):
    out = tiny_run(workload)
    assert out["correct"] is True, out["checks"]
    assert list(out)[-2:] == ["checks", "forbidden_modules"]
    assert out["forbidden_modules"] == []
    assert out["failed"] == 0 and out["attempted"] >= 2
    name = "prove_proofs_per_s" if workload.startswith("prove") else "verify_proofs_per_s"
    assert set(out["metrics"]) == {name, "setup_s"}
    assert all(c["value"] == 0 and c["limit"] == 0 for c in out["checks"].values())


@pytest.mark.parametrize("workload", ["prove.ref-ring4096", "verify.ref-ring4096"])
def test_tiny_traced_run_reports_its_layers(workload):
    out = tiny_run(workload, trace=True)
    assert out["correct"] is True
    want = {m["name"] for m in manifest.metrics_for(HELD, workload, True)}
    # on the CPU no device operation runs: the trace's shares have nothing to read
    assert set(out["metrics"]) == want - {f"kernels_roofline.{workload.split('.')[0]}"}
    assert out["device"]["window_s"] > 0 and "breakdown" in out


def _broken(monkeypatch, cls, name, fault):
    orig = getattr(cls, name)
    state = {}

    def wrapped(self, *args, **kw):
        out = orig(self, *args, **kw)
        prev, state["prev"] = state.get("prev"), out
        return fault(out, prev)

    monkeypatch.setattr(cls, name, wrapped)


def _alter_proof(p):
    import copy

    q = copy.copy(p)
    q.R, q.comS1 = p.comS1, p.R
    return q


PROVE_FAULTS = {
    "an answer altered": lambda out, prev: [_alter_proof(p) for p in out],
    "half the batch left out": lambda out, prev: out[: len(out) // 2],
    "the state returned unchanged": lambda out, prev: prev if prev is not None else out,
}
VERIFY_FAULTS = {
    "an answer altered": lambda out, prev: [not v for v in out],
    "every proof accepted": lambda out, prev: [True] * len(out),
    "half the batch left out": lambda out, prev: out[: len(out) // 2],
}


@pytest.mark.parametrize("fault", sorted(PROVE_FAULTS))
def test_prove_cell_fails_with_a_broken_prover(monkeypatch, fault):
    from zkecdsa_tpu_torch.protocol.batch import BatchProver

    _broken(monkeypatch, BatchProver, "prove", PROVE_FAULTS[fault])
    out = tiny_run("prove.ref-ring4096", seconds=0.1)
    assert out["correct"] is False, (fault, out["checks"])


@pytest.mark.parametrize("fault", sorted(VERIFY_FAULTS))
def test_verify_cell_fails_with_a_broken_verifier(monkeypatch, fault):
    from zkecdsa_tpu_torch.protocol.batch_verify import BatchVerifier

    _broken(monkeypatch, BatchVerifier, "verify", VERIFY_FAULTS[fault])
    out = tiny_run("verify.ref-ring4096")
    assert out["correct"] is False, (fault, out["checks"])


@pytest.mark.parametrize("workload", ["prove.ref-ring4096", "verify.ref-ring4096"])
def test_control_is_not_correct(workload):
    from zkbench import control

    out = control.control(workload, SEED, 2, device="cpu", overrides=TINY, man=HELD)
    assert out["sampled"] > 0
    assert out["correct"] is False, out["checks"]


def _command(cwd, *extra):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", PYTHONPATH="")
    return subprocess.run(
        [sys.executable, "zkbench/run.py", "--workload", "verify.ref-ring4096", "--seed", str(SEED),
         "--seconds", "1", "--trace", "0", *extra],
        cwd=cwd, capture_output=True, text=True, env=env, timeout=300,
    )


def test_command_fails_without_a_card_and_prints_no_result():
    got = _command(ROOT)
    assert got.returncode != 0
    assert got.stdout.strip() == ""
    assert "CUDA is not available" in got.stderr


def test_command_fails_without_the_program(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "zkbench", tmp_path / "zkbench")
    got = _command(tmp_path)
    assert got.returncode != 0
    assert got.stdout.strip() == ""


def test_nothing_the_benchmark_runs_loads_jax():
    """A tiny run in a fresh process: no loaded module's top-level name is
    ``jax``, ``jaxlib``, ``flax`` or ``zkecdsa_tpu`` (``zkecdsa_tpu_torch``
    is the port, and passes)."""
    code = f"""
import sys, time, json
sys.path.insert(0, {str(ROOT)!r})
if __name__ == "__main__":
    import torch
    torch.set_num_threads(1)
    from zkbench.harness import cell
    out = cell.run("verify.ref-ring4096", {SEED}, 0.0, False, t_start=time.perf_counter(), device="cpu",
                   overrides={TINY!r}, log=lambda m: None)
    import zkbench.control, zkbench.harness.check  # noqa: F401
    top = sorted({{m.split(".", 1)[0] for m in sys.modules}})
    print(json.dumps({{"found": out["forbidden_modules"], "top": top}}))
"""
    got = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=900,
                         env=dict(os.environ, PYTHONPATH=""))
    assert got.returncode == 0, got.stderr[-2000:]
    res = json.loads(got.stdout.strip().splitlines()[-1])
    assert res["found"] == []
    assert "zkecdsa_tpu_torch" in res["top"]
    assert not {"jax", "jaxlib", "flax", "zkecdsa_tpu"} & set(res["top"])


@pytest.fixture
def cuda():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the benchmark measures the card and runs nowhere else")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["verify.ref-ring4096"])
def test_command_on_the_card(cuda, workload):
    got = subprocess.run(
        [sys.executable, "zkbench/run.py", "--workload", workload, "--seed", str(SEED), "--seconds", "1",
         "--trace", "0"], cwd=ROOT, capture_output=True, text=True, timeout=900,
    )
    assert got.returncode == 0, got.stderr[-4000:]
    res = json.loads(got.stdout.strip().splitlines()[-1])
    assert res["correct"] is True and res["device"]["platform"] == "gpu"
    assert got.stderr.strip().splitlines()[-1].startswith("check ")
