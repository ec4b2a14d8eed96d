"""The reduction from spans and a device trace to the per-layer metrics:
nested spans' self time, the device's busy time as a union of intervals,
idle stretches named by the innermost host span, kernel names."""

import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from zkbench.harness import devtrace, spans  # noqa: E402


def test_nested_spans_count_self_time_once():
    sp = spans.Spans(record=False)
    sp.batch = 0
    with sp.stage("batch"):
        with sp.stage("outer"):
            time.sleep(0.02)
            with sp.stage("inner"):
                time.sleep(0.03)
    assert sp.parents == {"outer": "batch", "inner": "outer"}
    inner, outer = sp.self_s[(0, "inner")], sp.self_s[(0, "outer")]
    assert 0.025 < inner < 0.2 and 0.015 < outer < 0.2
    assert sp.self_s[(0, "batch")] < 0.01  # its children's time is theirs
    assert sp.per_batch({"outer", "inner"}, [0]) == inner + outer
    assert sp.per_batch({"absent"}, [0]) is None


def test_device_trace_busy_idle_and_names(tmp_path):
    X = "X"
    events = [
        {"ph": X, "cat": "user_annotation", "name": "batch", "ts": 0, "dur": 100},
        {"ph": X, "cat": "user_annotation", "name": "assembly", "ts": 40, "dur": 50},
        {"ph": X, "cat": "user_annotation", "name": "batch", "ts": 200, "dur": 100},
        {"ph": X, "cat": "kernel", "name": "void (anonymous namespace)::ec_add_kernel<3, 4>(long long, unsigned int*)",
         "ts": 10, "dur": 20},
        {"ph": X, "cat": "kernel", "name": "void (anonymous namespace)::ec_add_kernel<3, 4>(long long, unsigned int*)",
         "ts": 20, "dur": 15},  # overlaps: counted once in busy
        {"ph": X, "cat": "gpu_memcpy", "name": "Memcpy HtoD", "ts": 210, "dur": 5},
        {"ph": X, "cat": "kernel", "name": "outside", "ts": 500, "dur": 50},  # past the window
    ]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": events}))
    t = devtrace.read(str(path), "batch")
    assert abs(t.window_s - 300e-6) < 1e-12
    assert abs(t.busy_s - 30e-6) < 1e-12  # [10, 35) and [210, 215)
    assert abs(t.kernels["ec_add_kernel"] - 35e-6) < 1e-12
    # idle, by the innermost span open: batch [0,10) [35,40) [90,100)
    # [200,210) [215,300); assembly [40,90); between the batches [100,200)
    assert {k: round(v * 1e6, 6) for k, v in t.idle.items()} == {
        "batch": 120.0, "assembly": 50.0, "outside any span": 100.0}


def test_kernel_names():
    assert devtrace.kernel_name("void (anonymous namespace)::straus_kernel<0, 4>(long long, int)") == "straus_kernel"
    assert devtrace.kernel_name("(anonymous namespace)::shamir_kernel(long long)") == "shamir_kernel"
    assert devtrace.kernel_name("void at::native::vectorized_elementwise_kernel<4, at::native::FillFunctor<int> >"
                                "(int, at::native::FillFunctor<int>)") == "vectorized_elementwise_kernel"
