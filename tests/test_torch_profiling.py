"""The port's profiling helpers and ``Config.profile_dir``
(``zkecdsa_tpu_torch.utils``), without the JAX package: ``trace`` writes a
``torch.profiler`` Chrome trace (CPU activity here; CUDA activity too on a
card), ``device_time`` reads the device's busy time and every kernel's
time from such a file, ``kernel_launch_us`` picks one kernel's launches out
of it (``case_launch_us``: case by case), ``kernel_device_ms`` and
``kernel_ns_per_op`` time a call on the card
(from a trace, and with CUDA events)."""

import dataclasses
import json

import pytest
import torch

from zkecdsa_tpu_torch.curves.instances import p256
from zkecdsa_tpu_torch.ops import curve_ops as tcurve
from zkecdsa_tpu_torch.utils import config as tconfig
from zkecdsa_tpu_torch.utils import profiling as tprof

# One intra-op thread: the suite runs several worker processes on the same
# cores, and an oversubscribed OpenMP pool spins instead of working.
torch.set_num_threads(1)


@pytest.fixture
def saved_config():
    cfg = tconfig.get_config()
    yield cfg
    tconfig.set_config(cfg)


def test_profile_dir_from_env_is_a_string(monkeypatch):
    """ZKECDSA_PROFILE_DIR is taken as a string, the int fields still as
    ints (the reference's ``Config.from_env``)."""
    monkeypatch.setenv("ZKECDSA_PROFILE_DIR", "build/trace")
    monkeypatch.setenv("ZKECDSA_VERIFY_ROUNDS", "80")
    cfg = tconfig.Config.from_env()
    assert cfg.profile_dir == "build/trace"
    assert cfg.verify_rounds == 80 and isinstance(cfg.verify_rounds, int)
    monkeypatch.delenv("ZKECDSA_PROFILE_DIR")
    assert tconfig.Config.from_env().profile_dir is None


def _point_add():
    pts = tcurve.p256_ops.pack_points([p256.generator()] * 2)
    return tcurve.ec_add(tcurve.p256_ops, pts, pts)  # CPU tensor: the plain version


def test_trace_writes_a_file(tmp_path):
    """A trace of plain-version work on the CPU is a Chrome trace file in
    the directory, with the block's operators in it and no device time."""
    with tprof.trace(str(tmp_path / "t")) as tr:
        _point_add()
    assert tr.path.startswith(str(tmp_path / "t"))
    with open(tr.path) as fh:
        events = json.load(fh)["traceEvents"]
    assert any(ev.get("name", "").startswith("aten::") for ev in events)
    assert tr.profile.key_averages()
    assert tprof.device_time(tr.path) == (0.0, [])


def test_trace_defaults_to_profile_dir(tmp_path, saved_config):
    with pytest.raises(ValueError, match="ZKECDSA_PROFILE_DIR"):
        with tprof.trace():
            pass
    tconfig.set_config(dataclasses.replace(saved_config, profile_dir=str(tmp_path)))
    with tprof.trace() as tr:
        _point_add()
    assert [p.name for p in tmp_path.iterdir()] == [tr.path.rsplit("/", 1)[1]]


def test_device_time_counts_overlaps_once(tmp_path):
    """Busy time is the union of the device intervals (kernels, copies,
    sets); the kernels come in the order they started; host events are
    not counted."""
    ev = [
        {"ph": "X", "cat": "kernel", "name": "a", "ts": 0.0, "dur": 10.0},
        {"ph": "X", "cat": "kernel", "name": "b", "ts": 5.0, "dur": 10.0},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD", "ts": 30.0, "dur": 2.0},
        {"ph": "X", "cat": "kernel", "name": "a", "ts": 40.0, "dur": 1.5},
        {"ph": "X", "cat": "cpu_op", "name": "aten::add", "ts": 0.0, "dur": 100.0},
        {"ph": "i", "cat": "kernel", "name": "marker", "ts": 50.0},
    ]
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": ev}))
    assert tprof.device_time(str(path)) == (18.5, [(0.0, "a", 10.0), (5.0, "b", 10.0), (40.0, "a", 1.5)])


def test_kernel_launch_us_matches_global_names():
    """A kernel counts by its __global__ name followed by a template's
    ``<`` or a call's ``(``: not by a longer name that starts the same."""
    kernels = [
        (0.0, "void field_mul_kernel<SolinasMul, false>(long long, Operand)", 2.0),
        (1.0, "field_sum_kernel(long long, long long)", 3.0),
        (2.0, "void old_field::field_mul_kernel<0, true>(long long)", 4.0),
        (3.0, "field_mul_kernel_other(int)", 5.0),
        (4.0, "noop_kernel()", 1.5),
    ]
    assert tprof.kernel_launch_us(kernels, ["field_mul_kernel"]) == [2.0, 4.0]
    assert tprof.kernel_launch_us(kernels, ("field_sum_kernel", "noop_kernel")) == [3.0, 1.5]
    assert tprof.kernel_launch_us(kernels, ["chain_kernel"]) == []


def test_case_launch_us_by_launch_range(tmp_path):
    """A kernel counts for the case whose host range holds its launch
    call (same correlation id), whatever its own start on the device; a
    lost launch costs its case a sample and nothing more; a kernel of
    another name in the range, or launched outside every range, is not
    counted; a label with no range raises."""
    def span(cat, name, ts, dur, **args):
        return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "args": args}

    ev = [
        span("user_annotation", "case 0", 0.0, 10.0),
        span("user_annotation", "case 1", 10.0, 10.0),
        span("cuda_runtime", "cudaLaunchKernel", 1.0, 0.5, correlation=1),
        span("cuda_runtime", "cudaLaunchKernel", 2.0, 0.5, correlation=2),
        span("cuda_runtime", "cudaLaunchKernel", 3.0, 0.5, correlation=3),
        span("cuda_runtime", "cudaLaunchKernel", 11.0, 0.5, correlation=4),
        span("cuda_driver", "cuLaunchKernel", 12.0, 0.5, correlation=5),
        span("cuda_runtime", "cudaLaunchKernel", 30.0, 0.5, correlation=6),
        span("kernel", "void f_kernel<1>(int)", 15.0, 2.0, correlation=1),  # runs in case 1's time
        span("kernel", "copy_kernel(int)", 16.0, 9.0, correlation=2),
        span("kernel", "void f_kernel<1>(int)", 21.0, 3.0, correlation=4),
        span("kernel", "g_kernel(int)", 22.0, 4.0, correlation=5),
        span("kernel", "void f_kernel<1>(int)", 31.0, 7.0, correlation=6),
    ]  # correlation 3's kernel was lost
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": ev}))
    got = tprof.case_launch_us(str(path), ["case 0", "case 1"], [["f_kernel"], ["f_kernel", "g_kernel"]])
    assert got == [[2.0], [3.0, 4.0]]
    with pytest.raises(RuntimeError, match="no range"):
        tprof.case_launch_us(str(path), ["case 2"], [["f_kernel"]])


def test_kernel_device_ms_needs_a_card(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tprof.kernel_device_ms([(_point_add, ["ec_add_kernel"], 1)], 2, str(tmp_path))


def test_kernel_ns_per_op_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tprof.kernel_ns_per_op(_point_add, (), 2)


@pytest.mark.cuda
def test_kernel_ns_per_op_on_card():
    """The median of CUDA-event times of an ec_add launch, per point."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc: the CUDA kernels run only on the card")
    pts = tcurve.p256_ops.pack_points([p256.generator()] * 1024, "cuda")
    ns = tprof.kernel_ns_per_op(lambda: tcurve.ec_add(tcurve.p256_ops, pts, pts), (), 1024, iters=5)
    assert 0.0 < ns < 1e6


@pytest.mark.cuda
def test_kernel_device_ms_on_card(tmp_path):
    """ec_add launches at two sizes in one trace, case by case."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc: the CUDA kernels run only on the card")
    small = tcurve.p256_ops.pack_points([p256.generator()] * 32, "cuda")
    big = tcurve.p256_ops.pack_points([p256.generator()] * 65536, "cuda")
    ms = tprof.kernel_device_ms(
        [(lambda: tcurve.ec_add(tcurve.p256_ops, P, P), ["ec_add_kernel"], 1) for P in (small, big)],
        5, str(tmp_path))
    assert 0.0 < ms[0] < ms[1] < 1e3
