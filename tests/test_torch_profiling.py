"""The port's profiling helpers and ``Config.profile_dir``
(``zkecdsa_tpu_torch.utils``), without the JAX package: ``trace`` writes a
``torch.profiler`` Chrome trace (CPU activity here; CUDA activity too on a
card), ``device_time`` reads the device's busy time and every kernel's
time from such a file, ``kernel_ns_per_op`` times a call on the card with CUDA
events."""

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
