"""``BENCHMARK.json`` against the benchmark's contract, and the harness
finding every configuration, traffic mix and metric by name, also ones
added as new files alone."""

import json
import re
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from zkbench.harness import manifest, traffic  # noqa: E402

MAN = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")
LINE = re.compile(r"[^\t\n\r]{1,200}")
METRICS = MAN["end_to_end"] + MAN["per_layer"]


def test_top_level_keys_and_sizes():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert MAN["command"] == ["python3", "zkbench/run.py"] and MAN["paths"] == ["zkbench"]
    assert isinstance(MAN["run_seconds"], int) and 1 <= MAN["run_seconds"] <= 51
    cells = len(MAN["workloads"])
    assert 1 <= cells <= 24 and 1 <= len(MAN["configs"]) <= 24
    assert 1 <= len(MAN["end_to_end"]) <= 16 and 1 <= len(MAN["per_layer"]) <= 128
    # a full check with 24 cells fits its time
    assert (2 + 14 * 24) * (MAN["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("entry", MAN["configs"] + MAN["workloads"] + METRICS, ids=lambda e: e["name"])
def test_names_units_and_lines(entry):
    assert NAME.fullmatch(entry["name"])
    for key in ("config", "traffic"):
        if key in entry:
            assert NAME.fullmatch(entry[key])
    for key in ("why", "layer", "source"):
        if key in entry:
            assert LINE.fullmatch(entry[key]), key
    if "unit" in entry:
        assert UNIT.fullmatch(entry["unit"])
        assert entry["better"] in ("lower", "higher")
    for key in entry.get("reduced", []):
        assert NAME.fullmatch(key)


def test_entries_have_just_their_keys():
    for c in MAN["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("zkbench/") and (ROOT / c["file"]).is_file()
    for w in MAN["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] == 1
    for m in MAN["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in MAN["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
    names = [e["name"] for e in MAN["configs"]] + [e["name"] for e in MAN["workloads"]] + [m["name"] for m in METRICS]
    assert len(names) == len(set(names))
    assert "setup_s" in {m["name"] for m in MAN["end_to_end"]}


def test_every_cell_reports_setup_another_end_to_end_and_a_layer():
    e2e = {m["name"]: m for m in MAN["end_to_end"]}
    for w in MAN["workloads"]:
        got = [m["name"] for m in manifest.metrics_for(MAN, w["name"], False)]
        assert "setup_s" in got and len(got) >= 2
        layers = manifest.metrics_for(MAN, w["name"], True)
        assert layers
        for m in layers:  # each moves an end-to-end metric the cell reports
            assert m["moves"] in got and m["moves"] in e2e
    for m in MAN["per_layer"]:
        if m["name"].endswith("_roofline") or "_roofline." in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"


def test_each_config_mix_and_metric_is_found_by_name():
    for c in MAN["configs"]:
        cfg = traffic.Config.load(manifest.config_file(MAN, c["name"]))
        assert cfg.name == c["name"]
    for w in MAN["workloads"]:
        assert w["config"] in {c["name"] for c in MAN["configs"]}
        assert traffic.Mix.load(manifest.traffic_file(w["traffic"])).name == w["traffic"]
    for m in METRICS:
        assert callable(manifest.reader(m["name"]))


def test_every_config_is_used_and_reduced_lists_what_changed():
    used = {w["config"] for w in MAN["workloads"]}
    for c in MAN["configs"]:
        assert c["name"] in used
        raw = json.loads((ROOT / c["file"]).read_text())
        for key in c["reduced"]:
            assert key in raw["published"] and raw[key] != raw["published"][key]


def test_a_new_config_mix_and_metric_are_picked_up_as_files_alone(tmp_path):
    """In a copy of the benchmark: a configuration, a traffic mix, a cell
    and a per-layer metric added as new files and manifest entries are
    found and read with no file of the harness edited."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "zkbench", tmp_path / "zkbench")
    bench = tmp_path / "zkbench"
    before = {p.relative_to(tmp_path): p.read_bytes() for p in bench.rglob("*") if p.is_file()}
    cfg = json.loads((bench / "configs" / "ref-ring4096.json").read_text())
    cfg.update(name="ref-ring8192", ring=8192)
    (bench / "configs" / "ref-ring8192.json").write_text(json.dumps(cfg))
    mix = json.loads((bench / "traffic" / "verify.json").read_text())
    mix.update(batch=64, why="batches of 64")
    (bench / "traffic" / "verify-b64.json").write_text(json.dumps(mix))
    (bench / "metrics" / "wire_share.verify.py").write_text(
        "def read(r):\n    return 100.0 * r.spans.per_batch({'serde'}, r.batches) / r.window_s\n")
    man = json.loads((tmp_path / "BENCHMARK.json").read_text())
    man["configs"].append({"name": "ref-ring8192", "source": "x", "file": "zkbench/configs/ref-ring8192.json",
                           "reduced": ["ring"], "why": "a larger ring"})
    man["workloads"].append({"name": "verify-b64.ref-ring8192", "config": "ref-ring8192", "traffic": "verify-b64",
                             "chips": 1, "why": "batches of 64 over a ring of 8192"})
    man["per_layer"].append({"name": "wire_share.verify", "unit": "%", "better": "lower", "source": "program_span",
                             "layer": "wire", "moves": "verify_proofs_per_s"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(man))

    man = manifest.load(tmp_path)
    spec = manifest.cell(man, "verify-b64.ref-ring8192")
    assert traffic.Config.load(manifest.config_file(man, spec["config"], tmp_path)).ring == 8192
    assert traffic.Mix.load(manifest.traffic_file(spec["traffic"], bench)).batch == 64
    names = [m["name"] for m in manifest.metrics_for(man, spec["name"], True)]
    assert "wire_share.verify" in names
    read = manifest.reader("wire_share.verify", bench)

    class Spans:
        def per_batch(self, names, batches):
            return 2.0

    class R:
        spans, batches, window_s = Spans(), [0], 8.0

    assert read(R()) == 25.0
    after = {p.relative_to(tmp_path): p.read_bytes() for p in bench.rglob("*") if p.is_file()}
    assert all(after[k] == v for k, v in before.items())  # nothing that was there changed


def test_traffic_is_the_same_work_for_every_seed():
    """Every seed gives a mix's batches the same sizes and the same number
    of tampered slots; only which instances, tapes and slots differ."""
    mix = traffic.Mix.load(manifest.traffic_file("verify"))
    for seed in (1, 2**33 + 5):
        counts = [sum(1 for e in traffic.verify_batch(mix, seed, b) if e[0] == "tampered") for b in range(6)]
        assert counts == [8] * 6
        assert len({e for e in traffic.verify_batch(mix, seed, 0)}) == mix.batch
    b16 = traffic.Mix.load(manifest.traffic_file("verify-b16"))
    assert [sum(1 for e in traffic.verify_batch(b16, 9, b) if e[0] == "tampered") for b in range(4)] == [0, 1, 0, 1]
    prove = traffic.Mix.load(manifest.traffic_file("prove"))
    idx, tapes = traffic.prove_batch(prove, 3, 0)
    assert len(set(idx)) == prove.batch and len(set(tapes)) == prove.batch
    assert traffic.prove_batch(prove, 3, 0) == (idx, tapes) and traffic.prove_batch(prove, 4, 0)[0] != idx
