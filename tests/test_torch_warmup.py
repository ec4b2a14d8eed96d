"""``BatchProver.warmup`` on the CPU: it runs the phase-B path a prove
takes (``phase_b_flat`` without a mesh, ``phase_b`` with one), draws no
randomness, and a prove after it gives the golden vector's bytes, the
bytes of a prove without it (tests/test_torch_prove.py)."""

import json
from pathlib import Path

import pytest
import torch

import torch_mesh_ranks as ranks
from zkecdsa_tpu_torch.parallel import launch
from zkecdsa_tpu_torch.protocol import batch as tbatch
from zkecdsa_tpu_torch.serde import read_json, write_json
from zkecdsa_tpu_torch.utils import rng as trng
from zkecdsa_tpu_torch.zkp_attest_list import SignatureProofList, SystemParametersList

# One intra-op thread: the suite runs several worker processes on the same
# cores, and an oversubscribed OpenMP pool spins instead of working.
torch.set_num_threads(1)

VEC = Path(__file__).resolve().parent / "vectors"
TIMEOUT = 300  # seconds for the mesh rank
E = (16,)  # one even-round capacity: K = 64 rows at n <= 4
WARM_N, WARM_RING = 3, 2  # more instances than ring keys


@pytest.fixture(scope="module")
def golden():
    inputs = json.loads((VEC / "golden_inputs.json").read_text())
    params = read_json(SystemParametersList, (VEC / "golden_params.json").read_text())
    return inputs, params


@pytest.fixture(scope="module")
def warmed(golden):
    """A prover on the golden parameters after ``warmup(WARM_N)`` at a
    ring of WARM_RING keys under spies on the two phase-B functions,
    inside a deterministic source whose state is read before and after."""
    _, params = golden
    bp = tbatch.BatchProver(params, device="cpu")
    calls = []

    def spy(name):
        fn = getattr(tbatch, name)

        def call(*args):
            calls.append((name, tuple(args[-1].shape)))
            return fn(*args)

        return call

    with pytest.MonkeyPatch.context() as mp:
        for name in ("phase_b", "phase_b_flat"):
            mp.setattr(tbatch, name, spy(name))
        with trng.deterministic(5) as src:
            before = src.state()
            bp.warmup(WARM_N, E, ring=WARM_RING)
            after = src.state()
    return bp, calls, before, after


def test_warmup_runs_phase_b_flat_without_a_mesh(warmed):
    _, calls, _, _ = warmed
    assert calls == [("phase_b_flat", (tbatch._flat_rows(WARM_N * E[0]),))]


def test_warmup_draws_no_randomness(warmed):
    _, _, before, after = warmed
    assert before == after


def test_prove_after_warmup_gives_the_golden_bytes(golden, warmed):
    inputs, _ = golden
    bp = warmed[0]
    got = bp.prove(
        [bytes.fromhex(inputs["msg_hash_hex"])],
        [bytes.fromhex(inputs["sig_hex"])],
        [bytes.fromhex(inputs["pub_hex"])],
        [inputs["which"]],
        [int(v, 16) for v in inputs["ring"]],
        [trng.DeterministicSource(inputs["tape_seed"])],
    )
    assert [write_json(SignatureProofList, p) for p in got] == [(VEC / "golden_proof.json").read_text()]


def test_warmup_runs_phase_b_under_a_mesh(golden):
    """On a 1 x 1 mesh (one gloo rank, the CPU) the warm-up takes the
    [N, E] ``phase_b``, which runs its rows through ``phase_b_flat``."""
    inputs, params = golden
    (report,) = launch.run(
        ranks.warmup_spy, 1, args=(write_json(SystemParametersList, params), 1, E, len(inputs["ring"])),
        timeout=TIMEOUT,
    )
    assert [tuple(c) for c in report["calls"]] == [("phase_b", (1, E[0])), ("phase_b_flat", (E[0],))]


def test_flat_rows_quantization():
    """K as a prove quantizes it: multiples of 64 up to 512 rows, of 512
    beyond, at least one quantum."""
    assert [tbatch._flat_rows(k) for k in (0, 1, 64, 65, 512, 513, 10240, 14336)] == [
        64, 64, 64, 128, 512, 1024, 10240, 14336,
    ]
