"""The port's profiling helpers and ``Config.profile_dir``
(``zkecdsa_tpu_torch.utils``), without the JAX package: ``trace`` writes a
``torch.profiler`` Chrome trace (CPU activity here; CUDA activity too on a
card), ``device_time`` reads the device's busy time and every kernel's
time from such a file, ``kernel_launch_us`` picks one kernel's launches out
of it (``case_launch_us``: case by case), ``kernel_device_ms`` and
``kernel_ns_per_op`` time a call on the card
(from a trace, and with CUDA events); ``StageTimer``'s spans and counters,
``tracing`` and the counting sites of the OS source, ``bignum.rnd`` and
``serde.read_json`` (on its native and its Python path)."""

import contextlib
import dataclasses
import gc
import json
import time
from pathlib import Path

import pytest
import torch

from zkecdsa_tpu_torch.bignum import big as tbig
from zkecdsa_tpu_torch.curves.instances import p256
from zkecdsa_tpu_torch.ops import curve_ops as tcurve
from zkecdsa_tpu_torch.runtime import native
from zkecdsa_tpu_torch.serde import read_json, write_json
from zkecdsa_tpu_torch.utils import config as tconfig
from zkecdsa_tpu_torch.utils import profiling as tprof
from zkecdsa_tpu_torch.utils import rng as trng
from zkecdsa_tpu_torch.zkp_attest_list import SignatureProofList

VEC = Path(__file__).resolve().parent / "vectors"

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
        [(lambda P=P: tcurve.ec_add(tcurve.p256_ops, P, P), ["ec_add_kernel"], 1) for P in (small, big)],
        5, str(tmp_path))
    assert 0.0 < ms[0] < ms[1] < 1e3


# ---- spans, counters and the installed tracer ----


def _busy(ms: float) -> None:
    t_end = time.perf_counter() + ms * 1e-3
    while time.perf_counter() < t_end:
        pass


def test_spans_ids_parents_calls_and_self_time():
    """Each span has its own id, its parent's id and the call id of the
    tracing block it opened in (None outside any); a stage's self time is
    its seconds less its children's; ``stages`` and ``counts`` keep
    their meaning."""
    t = tprof.StageTimer()
    stage = tprof.stages(t)
    for _ in range(2):
        with tprof.tracing(t):
            with stage("outer"):
                _busy(2)
                with stage("inner"):
                    _busy(3)
                with stage("inner"):
                    _busy(1)
    with stage("alone"):
        pass
    by_id = {s.id: s for s in t.spans}
    assert len(by_id) == len(t.spans) == 7
    outers = [s for s in t.spans if s.name == "outer"]
    inners = [s for s in t.spans if s.name == "inner"]
    assert [s.parent for s in outers] == [None, None]
    assert all(by_id[s.parent].name == "outer" for s in inners)
    assert outers[0].call is not None and outers[0].call != outers[1].call
    for o in outers:
        kids = [s for s in inners if s.parent == o.id]
        assert len(kids) == 2 and {s.call for s in kids} == {o.call}
        assert all(o.start_ns <= s.start_ns and s.end_ns <= o.end_ns for s in kids)
    assert t.spans[-1].name == "alone" and t.spans[-1].call is None
    kids_ns = sum(s.end_ns - s.start_ns for s in inners)
    outer_ns = sum(s.end_ns - s.start_ns for s in outers)
    assert t.self_s["outer"] == pytest.approx((outer_ns - kids_ns) * 1e-9)
    assert t.stages["outer"] == pytest.approx(outer_ns * 1e-9)
    assert t.self_s["inner"] == pytest.approx(t.stages["inner"])
    assert t.self_s["outer"] >= 3.9e-3 and t.stages["inner"] >= 7.9e-3
    assert t.counts == {"outer": 2, "inner": 4, "alone": 1}


def test_counters_go_to_the_innermost_open_span():
    """``count`` and a hot site's tally report to the innermost open span
    of the installed timer: a tally when a span starts or ends, or when
    the tracer is removed."""
    tally = tprof.Tally("test.tally")
    t = tprof.StageTimer()
    stage = tprof.stages(t)
    try:
        with tprof.tracing(t):
            tprof.count("test.n", 2)
            tally.values[0] += 5  # before any span: charged when "a" starts
            with stage("a"):
                tprof.count("test.n")
                tally.values[0] += 1  # charged to "b"'s parent when "b" starts
                with stage("b"):
                    tally.values[0] += 7
                    tprof.count("test.n", 0.5)
            tally.values[0] += 3  # charged when the tracer is removed
        assert tally.values == [0]
        assert t.counters == {
            (None, "test.n"): 2, (None, "test.tally"): 8,
            ("a", "test.n"): 1, ("a", "test.tally"): 1,
            ("b", "test.tally"): 7, ("b", "test.n"): 0.5,
        }
        assert "test.tally" in t.report()
    finally:
        tprof._tallies.remove(tally)


def test_tracing_nests_and_keeps_a_record_for_a_timer_without_count():
    """An inner block installs its own timer and restores the outer one;
    one ``gc.callbacks`` entry while any block is open; a timer without
    ``count`` gets its spans and counters kept beside it
    (``record_of``); ``current`` gives the installed timer."""

    class Plain:  # a timer with stage() alone
        def __init__(self):
            self.names = []

        @contextlib.contextmanager
        def stage(self, name):
            self.names.append(name)
            yield

    before = list(gc.callbacks)
    outer, inner = Plain(), tprof.StageTimer()
    assert tprof.TRACER is None and tprof.current() is None
    with tprof.tracing(outer):
        assert tprof.current() is outer and tprof.current(inner) is inner
        with tprof.stages(outer)("o"):
            with tprof.tracing(inner):
                assert tprof.current() is inner
                tprof.count("test.inner")
                gc.collect(2)
            tprof.count("test.outer")
            assert len(gc.callbacks) == len(before) + 1
    assert tprof.TRACER is None and gc.callbacks == before
    kept = tprof.record_of(outer)
    assert outer.names == ["o"] and [s.name for s in kept.spans] == ["o"]
    assert kept.counters == {("o", "test.outer"): 1}
    assert inner.counters[(None, "test.inner")] == 1
    assert inner.counters[(None, "gc.collections.2")] >= 1 and inner.counters[(None, "gc.s")] > 0
    assert tprof.record_of(inner) is None and tprof.record_of(tprof.StageTimer()) is None
    with tprof.tracing(None) as got:
        assert got is None and tprof.TRACER is None


class _CountingSource(trng.RandomSource):
    """The default source, with its own tallies of calls and bytes."""

    def __init__(self):
        self.calls = self.bytes = 0

    def random_bytes(self, n):
        self.calls += 1
        self.bytes += n
        return super().random_bytes(n)


def test_os_source_counters_equal_a_counting_wrapper():
    """``rng.os_calls`` and ``rng.os_bytes`` are the default source's
    calls and bytes, whatever draws them; ``rng.os_s`` its seconds."""
    src = _CountingSource()
    t = tprof.StageTimer()
    with trng.scoped(src), tprof.tracing(t):
        with tprof.stages(t)("draws"):
            for m in (3, 80, 2**255 + 95, tbig.byte_len(1) + 200):
                tbig.rnd(m)
            trng.random_bytes(33)
    assert src.calls > 4
    assert t.counters[("draws", "rng.os_calls")] == src.calls
    assert t.counters[("draws", "rng.os_bytes")] == src.bytes
    assert 0 < t.counters[("draws", "rng.os_s")] < 1


class _NoSnapshot:
    """A seeded source without ``state``/``restore``: ``rnd_many`` cannot
    rewind it."""

    def __init__(self, seed):
        self.source = trng.DeterministicSource(seed)

    def random_bytes(self, n):
        return self.source.random_bytes(n)


def _rnd_loop(tape, moduli):
    """The sequential ``rnd`` loop by hand: its values and rejections."""
    rejected, out = 0, []
    for m in moduli:
        k = tbig.byte_len(m)
        while (v := int.from_bytes(tape.random_bytes(k), "big")) >= m:
            rejected += 1
        out.append(v)
    return out, rejected


_MIXED_WIDTHS = [2, 3, 5, 80, 129, 255, 256, 257, 2**31 - 1, 2**255 + 95] * 4
_WIDE_ACCEPTED = [p256.order, 2**256 - 1] * 8  # 32 bytes, rejected ~2^-32
_WIDE_REJECTED = [2**255 + 95] * 12  # 32 bytes, each draw rejected ~1 time in 2


@pytest.mark.parametrize("draw, moduli", [
    ("rnd", _MIXED_WIDTHS),
    ("rnd_many", _MIXED_WIDTHS),  # mixed widths: the sequential loop
    ("rnd_many", _WIDE_ACCEPTED),  # the accepting path
    ("rnd_many", _WIDE_REJECTED),  # a rejection: the replay
    ("rnd_many_no_snapshot", _WIDE_REJECTED),  # a rejection, no replay
], ids=["rnd", "rnd_many-mixed", "rnd_many-accepted", "rnd_many-replay", "rnd_many-no-snapshot"])
def test_rnd_draws_less_calls_are_the_tapes_rejections(draw, moduli):
    """``rnd.draws - rnd.calls`` equals the rejections found by replaying
    the same ``DeterministicSource`` tape by hand, and ``rnd.calls`` is a
    modulus each, whether ``rnd`` or ``rnd_many`` draws: on its accepting
    path, its replay after a rejection, and with a source it cannot rewind
    (the draws after the rejected one then come anew, after its bulk
    read); a seeded source is not the OS's, so no ``rng.os_*`` counter
    moves."""
    t = tprof.StageTimer()
    src = _NoSnapshot(31337) if draw == "rnd_many_no_snapshot" else trng.DeterministicSource(31337)
    with trng.scoped(src), tprof.tracing(t):
        got = [tbig.rnd(m) for m in moduli] if draw == "rnd" else tbig.rnd_many(moduli)
    tape = trng.DeterministicSource(31337)
    if draw == "rnd_many_no_snapshot":
        k = tbig.byte_len(moduli[0])
        rows = [int.from_bytes(tape.random_bytes(k), "big") for _ in moduli]
        i = next(i for i, (v, m) in enumerate(zip(rows, moduli)) if v >= m)
        rest, rejected = _rnd_loop(tape, moduli[i:])
        want, rejected = rows[:i] + rest, rejected + 1
    else:
        want, rejected = _rnd_loop(tape, moduli)
    assert got == want and len(got) == len(moduli)
    assert (rejected > 0) == (moduli is not _WIDE_ACCEPTED)
    assert t.counters[(None, "rnd.calls")] == len(moduli)
    assert t.counters.get((None, "rnd.draws"), 0) - t.counters[(None, "rnd.calls")] == rejected
    assert not any(name.startswith("rng.os") for _, name in t.counters)


def test_no_tracer_moves_no_counter():
    """With no tracer installed the counting sites add nothing and no
    collector callback is added."""
    before = list(gc.callbacks)
    tbig.rnd(3)
    trng.RandomSource().random_bytes(8)
    tprof.count("test.n")
    read_json(SignatureProofList, (VEC / "golden_proof.json").read_text())
    assert all(not any(t.values) for t in tprof._tallies)
    assert gc.callbacks == before and tprof.TRACER is None


def test_read_json_under_a_tracer():
    """The traced parse gives the same proof as the untraced one, and
    counts the text's length and the seconds of the path that read it:
    the native decoder's call (``serde.native``, ``serde.native_s``) for
    the canonical golden wire, ``json.loads`` (``serde.fallback``,
    ``serde.json_s``) for the same proof pretty-printed."""
    text = (VEC / "golden_proof.json").read_text()
    pretty = json.dumps(json.loads(text), indent=1)
    plain = read_json(SignatureProofList, text)
    t = tprof.StageTimer()
    with tprof.tracing(t):
        with tprof.stages(t)("serde"):
            traced = read_json(SignatureProofList, text)
        with tprof.stages(t)("serde.pretty"):
            traced_pretty = read_json(SignatureProofList, pretty)
    for proof in (traced, traced_pretty):
        assert write_json(SignatureProofList, proof) == write_json(SignatureProofList, plain) == text
    assert t.counters[("serde", "serde.bytes")] == len(text)
    assert t.counters[("serde.pretty", "serde.bytes")] == len(pretty)
    if native.available():
        assert t.counters[("serde", "serde.native")] == 1
        assert 0 < t.counters[("serde", "serde.native_s")] < t.stages["serde"]
    else:
        assert t.counters[("serde", "serde.fallback")] == 1
    assert t.counters[("serde.pretty", "serde.fallback")] == 1
    assert 0 < t.counters[("serde.pretty", "serde.json_s")] < t.stages["serde.pretty"]


def test_spans_share_the_profilers_clock(tmp_path):
    """Under a CPU ``torch.profiler`` session each span is a
    ``user_annotation`` range of its name, nested in its parent's range,
    its duration within 10% or 0.5 ms of the span's."""
    t = tprof.StageTimer("cpu")
    stage = tprof.stages(t)
    with tprof.trace(str(tmp_path)) as tr, tprof.tracing(t):
        with stage("clock.outer"):
            _busy(4)
            with stage("clock.inner"):
                _point_add()
                _busy(6)
            with stage("clock.inner"):
                _busy(2)
    with stage("clock.untraced"):
        pass
    with open(tr.path) as fh:
        events = json.load(fh)["traceEvents"]
    ranges = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"]) for e in events
              if e.get("ph") == "X" and e.get("cat") == "user_annotation"]
    by_id = {s.id: s for s in t.spans}
    traced = [s for s in t.spans if s.name != "clock.untraced"]
    mine = sorted((r for r in ranges if r[2].startswith("clock.")), key=lambda r: r[0])
    assert [r[2] for r in mine] == [s.name for s in sorted(traced, key=lambda s: s.start_ns)]
    for s, (a, b, _) in zip(sorted(traced, key=lambda s: s.start_ns), mine):
        assert abs((b - a) * 1e-6 - s.seconds) <= max(0.1 * s.seconds, 5e-4)
        holders = [r for r in mine if r[0] < a and b < r[1]]
        parent = min(holders, key=lambda r: r[1] - r[0])[2] if holders else None
        assert parent == (by_id[s.parent].name if s.parent else None)
