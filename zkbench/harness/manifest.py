"""``BENCHMARK.json`` and the files it names, found by name.

* a configuration: the file its ``configs`` entry gives;
* a traffic mix: ``zkbench/traffic/<traffic>.json``;
* a metric, end-to-end or per-layer: ``zkbench/metrics/<name>.py``, a
  reader with ``read(r)`` (see ``zkbench.harness.cell.Reading``);
* a path's roofline table: ``zkbench/roofline/<path>.json``.

Adding a configuration, a mix or a metric is adding its file and its
entry; nothing here changes.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent


def load(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as fh:
        return json.load(fh)


def cell(manifest: dict, workload: str) -> dict:
    for w in manifest["workloads"]:
        if w["name"] == workload:
            return w
    raise KeyError(f"no workload {workload!r} in BENCHMARK.json")


def config_file(manifest: dict, name: str, root: Path = ROOT) -> Path:
    for c in manifest["configs"]:
        if c["name"] == name:
            return root / c["file"]
    raise KeyError(f"no configuration {name!r} in BENCHMARK.json")


def traffic_file(name: str, bench_dir: Path = BENCH_DIR) -> Path:
    path = bench_dir / "traffic" / f"{name}.json"
    if not path.is_file():
        raise KeyError(f"no traffic mix {name!r}: {path} is missing")
    return path


def metrics_for(manifest: dict, workload: str, trace: bool) -> list[dict]:
    """The metrics a run of ``workload`` reports: the end-to-end ones
    untraced, the per-layer ones traced; an entry with a ``workloads``
    key only in the cells it lists."""
    entries = manifest["per_layer"] if trace else manifest["end_to_end"]
    return [m for m in entries if workload in m.get("workloads", [workload])]


def reader(name: str, bench_dir: Path = BENCH_DIR):
    """The ``read`` function of metric ``name``'s file."""
    path = bench_dir / "metrics" / f"{name}.py"
    if not path.is_file():
        raise KeyError(f"no reader for metric {name!r}: {path} is missing")
    spec = importlib.util.spec_from_file_location(f"zkbench_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
