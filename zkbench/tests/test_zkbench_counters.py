"""The port's own counters and spans in a traced run (the record the port
keeps beside the harness's ``Spans``, ``harness/port_record.py``): the
tiny CPU run reports the metrics read from it, the OS source's calls
and bytes equal the draws ``DrawLog`` kept, the wire's span keeps no
child, a parse under a tracer is the untraced parse, and every metric
and manifest entry that came before these is as it was."""

import hashlib
import json
import sys
import time
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from zkbench.harness import cell, manifest, spans  # noqa: E402
from zkbench.tests.test_zkbench_run import HELD, SEED, TINY  # noqa: E402

NEW = ("rng_os_s.verify", "rng_os_calls.verify", "rnd_rejected_share.verify", "attribution_s.verify")

# sha256 (first 16 hex digits) of each metric reader that came before the port's counters
READERS = {
    "assembly_s.prove.py": "7e3911f336943626",
    "assembly_s.verify.py": "aec07a71df8ead85",
    "device_idle_share.prove.py": "2e4babec572fc3c8",
    "device_idle_share.verify.py": "c1cd44f2597488b5",
    "device_params_s.py": "7873f8d08e7bfa3c",
    "gc_s.prove.py": "c81a6daa4864a7a5",
    "gc_s.verify.py": "009b69ac0f757442",
    "gk_recombine_s.verify.py": "5a776de782d1b72a",
    "host_prep_s.verify.py": "5f3d475a214cb3b4",
    "kernels_roofline.prove.py": "cf32198c0ab4951b",
    "kernels_roofline.verify.py": "c6c941f247bbb3b0",
    "prove_proofs_per_s.py": "037f3a0577275d2f",
    "serde_s.prove.py": "56cf0b56e6d40305",
    "serde_s.verify.py": "0ce76efea5c64298",
    "setup_s.py": "02252ddc558eb738",
    "tape_hash_s.prove.py": "a1cb75d2ac73a2a8",
    "verify_proofs_per_s.py": "2bfe3f4a4dd92055",
}


def _digest(b: bytes) -> str:
    return hashlib.sha256(b).hexdigest()[:16]


@pytest.fixture(autouse=True)
def one_thread():
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_tiny_traced_run_reports_the_port_counters(monkeypatch):
    """The four metrics read from the port's record are on the line; the
    OS source's calls and bytes in the traced batch are the draws the
    harness's log kept for it; ``serde`` has no child span; no
    attribution pass runs at N = 2 (the per-row path is taken directly)."""
    from zkecdsa_tpu_torch.utils import profiling

    takes, made = [], []

    class Log(cell.DrawLog):
        def take(self):
            calls = len(self.kept)
            out = super().take()
            takes.append((calls, len(out)))
            return out

    class Kept(spans.Spans):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            made.append(self)

    monkeypatch.setattr(cell, "DrawLog", Log)
    monkeypatch.setattr(spans, "Spans", Kept)
    lines = []
    out = cell.run("verify.ref-ring4096", SEED, 0.0, True, t_start=time.perf_counter(), device="cpu",
                   overrides=TINY, man=HELD, log=lines.append)
    assert out["correct"] is True
    got = out["metrics"]
    assert set(NEW) <= set(got)
    (sp,) = made
    rec = profiling.record_of(sp)
    assert len(takes) == 1 + TINY["trace_batches"]  # the set-up's batch, then the traced ones
    calls, nbytes = takes[1]
    total = {name: sum(n for (_, k), n in rec.counters.items() if k == name) for name in ("rng.os_calls", "rng.os_bytes")}
    assert total == {"rng.os_calls": calls, "rng.os_bytes": nbytes} and calls > 0
    assert got["rng_os_calls.verify"]["value"] == calls
    assert 0 < got["rng_os_s.verify"]["value"] < got["host_prep_s.verify"]["value"] + got["assembly_s.verify"]["value"]
    assert 50 < got["rnd_rejected_share.verify"]["value"] < 100
    assert got["attribution_s.verify"]["value"] == 0.0
    (nesting,) = [ln for ln in lines if ln.startswith("# spans and the span each nested in:")]
    assert "< serde" not in nesting and "serde < batch" in nesting


def test_metrics_of_a_port_without_a_record_are_left_out():
    """Over a port that keeps no record (before the counters) each new
    reader gives None and does not raise."""
    r = cell.Reading(path="verify", mix=None, cfg=None, proofs=2, window_s=1.0, setup_s=1.0,
                     spans=spans.Spans(record=False), batches=[0], trace=None, least_s=None,
                     setup_spans={}, gc_s={})
    for name in NEW:
        assert manifest.reader(name)(r) is None, name


def test_read_json_under_a_tracer_is_the_untraced_parse():
    """A proof parsed inside the harness's ``serde`` span with the
    harness's spans installed equals the untraced parse; the wire's
    counters are kept, and ``serde`` has no child span."""
    from zkecdsa_tpu_torch.serde import read_json, write_json
    from zkecdsa_tpu_torch.utils import profiling
    from zkecdsa_tpu_torch.zkp_attest_list import SignatureProofList

    text = (ROOT / "tests" / "vectors" / "golden_proof.json").read_text()
    sp = spans.Spans(record=False)
    with profiling.tracing(sp), sp.stage("serde"):
        traced = read_json(SignatureProofList, text)
    assert write_json(SignatureProofList, traced) == write_json(SignatureProofList, read_json(SignatureProofList, text))
    assert profiling.record_of(sp).counters[(None, "serde.bytes")] == len(text)
    assert sp.parents == {}


def test_what_came_before_is_unchanged():
    """Every metric reader and manifest entry that came before the port's
    counters is as it was; the new ones are appended at the end."""
    for name, want in READERS.items():
        assert _digest((ROOT / "zkbench" / "metrics" / name).read_bytes()) == want, name
    man = json.loads((ROOT / "BENCHMARK.json").read_text())
    layers = man.pop("per_layer")
    assert _digest(json.dumps(man, sort_keys=True).encode()) == "d82b764de4edb203"
    assert _digest(json.dumps(layers[:8], sort_keys=True).encode()) == "73bc4a9f7e1a1919"
    assert [m["name"] for m in layers[8:]] == list(NEW)
    for m in layers[8:]:
        assert m["workloads"] == ["verify.ref-ring4096"] and m["moves"] == "verify_proofs_per_s"
