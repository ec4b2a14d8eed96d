"""Profiling: the port's counterparts of the reference package's
``utils/profiling.py``.

* :func:`trace` - context manager around ``torch.profiler`` (CPU and CUDA
  activity) writing a Chrome trace file (chrome://tracing, Perfetto);
  :func:`device_time` reads such a file: the device's busy time (the
  union of its kernel and copy intervals) and every kernel's time;
  :func:`kernel_launch_us` and :func:`case_launch_us` pick kernels'
  launches out of it, and :func:`kernel_device_ms` traces loops of calls
  on the card and gives their kernels' own time a call, apart from the
  host's time around them;
* :class:`StageTimer` - nested spans (ids, parents, call ids, self time)
  and counters for the batched pipeline.  Work on a CUDA device is
  asynchronous, so with a CUDA ``device`` each span boundary synchronises
  it: a stage's time is then the time its own work took on the card, not
  the time to enqueue it;
* :func:`tracing` - installs a timer for a block (the entry points
  install the ``timer=`` they are given), so that code handed no timer
  reports :func:`count` and :class:`Tally` counters and the cyclic
  collector's passes to it.  With none installed a counting site costs
  one read of ``TRACER`` and one ``None`` test;
* :func:`kernel_ns_per_op` - median ns per logical op of a call on the
  card, timed with CUDA events.

The host layer (``bignum``, ``serde``, ``utils.rng``) imports this module,
so it imports ``torch`` only inside the functions that use it.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import gc
import itertools
import json
import os
import statistics
import time
import weakref
from typing import Callable

__all__ = [
    "Trace", "trace", "device_time", "kernel_launch_us", "case_launch_us", "kernel_device_ms", "Span", "StageTimer",
    "Tally", "tracing", "count", "current", "record_of", "stages", "kernel_ns_per_op",
]

# Chrome-trace categories of work on the device
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


@dataclasses.dataclass
class Trace:
    """What :func:`trace` captured: ``profile``, the ``torch.profiler``
    session (``key_averages()``), and ``path``, the Chrome trace file
    written when the block ends."""

    profile: object
    path: str


@contextlib.contextmanager
def trace(logdir: str | None = None):
    """Capture a ``torch.profiler`` trace of the block, CPU activity and,
    where a card is present, CUDA activity; on exit write it as a Chrome
    trace file into ``logdir``, which defaults to ``Config.profile_dir``
    (ZKECDSA_PROFILE_DIR).  Yields a :class:`Trace`."""
    if logdir is None:
        from .config import get_config

        logdir = get_config().profile_dir
    if logdir is None:
        raise ValueError("no trace directory: pass logdir or set ZKECDSA_PROFILE_DIR")
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    path = os.path.join(logdir, f"trace-{os.getpid()}-{time.time_ns()}.json")
    with profile(activities=activities) as prof:
        yield Trace(prof, path)
    prof.export_chrome_trace(path)


def device_time(path: str) -> tuple[float, list[tuple[float, str, float]]]:
    """(busy us, kernels) of a Chrome trace file: busy is the length of
    the union of the device's kernel, copy and set intervals (overlaps
    counted once); kernels the (start us, name, us) of every kernel, in
    the order they started."""
    with open(path) as fh:
        events = json.load(fh)
    events = events.get("traceEvents", []) if isinstance(events, dict) else events
    spans, kernels = [], []
    for ev in events:
        if ev.get("ph") != "X" or ev.get("cat") not in _DEVICE_CATS:
            continue
        t0, dur = float(ev["ts"]), float(ev.get("dur", 0.0))
        spans.append((t0, t0 + dur))
        if ev["cat"] == "kernel":
            kernels.append((t0, ev["name"], dur))
    busy, end = 0.0, float("-inf")
    for a, b in sorted(spans):
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy, sorted(kernels)


def kernel_launch_us(kernels, names) -> list[float]:
    """The us of each launch, in order, among ``kernels`` (the list
    :func:`device_time` returns) of the ``__global__`` functions
    ``names``: a trace names a kernel by its demangled signature, so a
    name counts where it is followed by ``<`` (a template) or ``(``."""
    return [us for _, name, us in kernels
            if any(f"{g}<" in name or f"{g}(" in name for g in names)]


def case_launch_us(path: str, labels, names) -> list[list[float]]:
    """From a Chrome trace of several cases, each run inside a
    ``torch.profiler.record_function`` range on the host labelled
    ``labels[i]``: the us of each launch of case i's kernels ``names[i]``.
    A kernel belongs to the range that holds its launch call (the CUDA
    runtime or driver event of the same correlation id), so a launch the
    trace lost costs its case one sample and moves nothing into another
    case.  Raises if a label has no range."""
    with open(path) as fh:
        events = json.load(fh)
    events = events.get("traceEvents", []) if isinstance(events, dict) else events
    spans = [ev for ev in events if ev.get("ph") == "X"]
    windows = {ev["name"]: (float(ev["ts"]), float(ev["ts"]) + float(ev.get("dur", 0.0)))
               for ev in spans if ev.get("cat") == "user_annotation" and ev.get("name") in labels}
    missing = [lab for lab in labels if lab not in windows]
    if missing:
        raise RuntimeError(f"the trace {path} has no range {missing}")
    launched = {ev["args"]["correlation"]: float(ev["ts"]) for ev in spans
                if ev.get("cat") in ("cuda_runtime", "cuda_driver") and "correlation" in ev.get("args", {})}
    out = [[] for _ in labels]
    for ev in spans:
        if ev.get("cat") != "kernel":
            continue
        t = launched.get(ev.get("args", {}).get("correlation"))
        for i, lab in enumerate(labels):
            lo, hi = windows[lab]
            if t is not None and lo <= t <= hi and kernel_launch_us([(0.0, ev["name"], 0.0)], names[i]):
                out[i].append(float(ev.get("dur", 0.0)))
    return out


def kernel_device_ms(cases, reps: int, logdir: str) -> list[float]:
    """The device ms a call of each case (``fn``, kernel names, launches
    a call): after a warm-up call of each, one :func:`trace` (into
    ``logdir``) of ``reps`` calls of each case in turn, each case in a
    range of its own (:func:`case_launch_us`); a case's time is its
    median launch times its launches a call.  That is the kernels' own
    time on the card, which a CUDA-event time of back-to-back calls adds
    the host's time between launches to.  A trace may lose launches (on
    an NVIDIA H100 under PyTorch's CUDA build: all of one trace's among a
    dozen, one of 240 in another), so a case needs half its launches, not
    all.  Raises without a card, or if a case has fewer."""
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("kernel_device_ms times CUDA work: CUDA is not available")
    for fn, _, _ in cases:
        fn()
    torch.cuda.synchronize()
    labels = [f"kernel_device_ms case {i}" for i in range(len(cases))]
    with trace(logdir) as tr:
        for label, (fn, _, _) in zip(labels, cases):
            with torch.profiler.record_function(label):
                for _ in range(reps):
                    fn()
                torch.cuda.synchronize()
    got = case_launch_us(tr.path, labels, [names for _, names, _ in cases])
    out = []
    for us, (_, names, n) in zip(got, cases):
        if 2 * len(us) < n * reps:
            raise RuntimeError(f"the trace {tr.path} holds {len(us)} of the {n * reps} launches of {list(names)}")
        out.append(statistics.median(us) * n / 1e3)
    return out


@dataclasses.dataclass(frozen=True, slots=True)
class Span:
    """A closed span of a :class:`StageTimer`: its name, its start and end
    (``time.perf_counter_ns``), its own id, its parent's id (None at the
    top) and the id of the :func:`tracing` block, one an entry-point call,
    it was opened in (None outside any)."""

    name: str
    start_ns: int
    end_ns: int
    id: int
    parent: int | None
    call: int | None

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) * 1e-9


class StageTimer:
    """Wall-clock accounting for the batched pipeline, as nested spans.

    * ``stages``: seconds a stage name, its child spans included, and
      ``counts``: entries a stage name;
    * ``self_s``: seconds a stage name less its child spans' seconds;
    * ``spans``: every closed :class:`Span`, in the order they closed;
    * ``counters``: what :meth:`count` added, keyed by (the innermost
      open span's name, or None, and the counter's name).

    With a CUDA ``device`` each span boundary synchronises it, so that a
    stage's time is its own work's on the card and not the time to
    enqueue it.  While a ``torch.profiler`` session is on, each span is
    also a ``record_function`` range of its name (never with
    ``record=False``), so that the device trace's timeline holds it."""

    def __init__(self, device=None, record: bool = True) -> None:
        self.stages: dict[str, float] = {}
        self.counts: dict[str, int] = {}
        self.self_s: dict[str, float] = {}
        self.spans: list[Span] = []
        self.counters: dict[tuple[str | None, str], float] = {}
        self._open: list[list] = []  # [name, id, start ns, children's ns] of each open span
        self._ids = itertools.count(1)
        self._record = record
        self._device = None
        if device is not None:
            import torch

            self._device = torch.device(device)
        self._sync = self._device is not None and self._device.type == "cuda"

    def _barrier(self) -> None:
        if self._sync:
            import torch

            torch.cuda.synchronize(self._device)

    @contextlib.contextmanager
    def stage(self, name: str):
        self._barrier()
        tr = TRACER
        call = tr.call if tr is not None and tr.keeper is self else None
        parent = self._open[-1][1] if self._open else None
        frame = [name, next(self._ids), 0, 0]
        with _range(name) if self._record else _NULL:
            self._open.append(frame)
            frame[2] = time.perf_counter_ns()
            try:
                yield
            finally:
                self._barrier()
                end = time.perf_counter_ns()
                self._open.pop()
                ns = end - frame[2]
                if self._open:
                    self._open[-1][3] += ns
                self.spans.append(Span(name, frame[2], end, frame[1], parent, call))
                self.stages[name] = self.stages.get(name, 0.0) + ns * 1e-9
                self.self_s[name] = self.self_s.get(name, 0.0) + (ns - frame[3]) * 1e-9
                self.counts[name] = self.counts.get(name, 0) + 1

    def count(self, name: str, n: float = 1) -> None:
        """Add ``n`` to counter ``name`` of the innermost open span."""
        key = (self._open[-1][0] if self._open else None, name)
        self.counters[key] = self.counters.get(key, 0) + n

    def report(self) -> str:
        """A line a stage, by seconds: seconds, share of all self time,
        entries; then a line a counter, by span."""
        total = sum(self.self_s.values()) or 1.0
        lines = [
            f"{name:<28s} {secs:8.3f}s  {100 * self.self_s[name] / total:5.1f}% self  x{self.counts[name]}"
            for name, secs in sorted(self.stages.items(), key=lambda kv: -kv[1])
        ]
        lines += [
            f"{span or '-':<28s} {name} {n:.6g}"
            for (span, name), n in sorted(self.counters.items(), key=lambda kv: (kv[0][0] or "", kv[0][1]))
        ]
        return "\n".join(lines)


# ---- the installed tracer: counters from code that is handed no timer ----


@dataclasses.dataclass(slots=True)
class _Tracer:
    timer: object  # what tracing() installed: anything with stage(name)
    keeper: object  # what counts go to: the timer, or the StageTimer kept for it
    call: int


TRACER: _Tracer | None = None  # the innermost tracing() block's, or None
_calls = itertools.count(1)
_kept: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()
_tallies: list["Tally"] = []
_GC_NAMES = ("gc.collections.0", "gc.collections.1", "gc.collections.2")
_gc_t0: float | None = None
_NULL = contextlib.nullcontext()


class Tally:
    """Plain numbers that a hot site adds to while a tracer is installed
    (``TRACER is not None``): ``values``, one slot a name, so that a
    draw costs no dict update.  At each span boundary of the installed
    timer, and when a tracer is removed, every nonzero value is counted
    to the open span and zeroed."""

    __slots__ = ("names", "values")

    def __init__(self, *names: str) -> None:
        self.names = names
        self.values = [0] * len(names)
        _tallies.append(self)


def _charge(tr: _Tracer) -> None:
    for t in _tallies:
        v = t.values
        for i, name in enumerate(t.names):
            if v[i]:
                tr.keeper.count(name, v[i])
                v[i] = 0


def _on_gc(phase: str, info: dict) -> None:
    global _gc_t0
    if phase == "start":
        _gc_t0 = time.perf_counter()
        return
    tr = TRACER
    if tr is not None and _gc_t0 is not None:
        tr.keeper.count(_GC_NAMES[info["generation"]], 1)
        tr.keeper.count("gc.s", time.perf_counter() - _gc_t0)
    _gc_t0 = None


@contextlib.contextmanager
def tracing(timer):
    """Install ``timer``, any object with ``stage(name)``, for the block,
    one entry-point call (a call id shared by the spans opened in it);
    ``None`` installs nothing.

    While it is installed, :func:`count` and the hot sites' tallies
    (:class:`Tally`) report to ``timer.count`` where the timer has one;
    for a timer without, to a :class:`StageTimer` that the port keeps
    beside it (:func:`record_of`), which also records the port's own
    spans.  The outermost block adds one ``gc.callbacks`` entry, which
    counts the cyclic collector's passes by generation
    (``gc.collections.<n>``) and its seconds (``gc.s``) to the open
    span, and removes it at its end."""
    global TRACER
    if timer is None:
        yield None
        return
    keeper = timer if callable(getattr(timer, "count", None)) else record_of(timer)
    if keeper is None:
        keeper = StageTimer(record=False)
        with contextlib.suppress(TypeError):  # a timer that cannot be weakly referenced keeps none
            _kept[timer] = keeper
    outer = TRACER
    if outer is not None:
        _charge(outer)
    tr = TRACER = _Tracer(timer, keeper, next(_calls))
    if outer is None:
        gc.callbacks.append(_on_gc)
    try:
        yield timer
    finally:
        _charge(tr)
        TRACER = outer
        if outer is None:
            gc.callbacks.remove(_on_gc)


def count(name: str, n: float = 1) -> None:
    """Add ``n`` to counter ``name`` of the installed tracer's open span;
    nothing when no tracer is installed."""
    tr = TRACER
    if tr is not None:
        tr.keeper.count(name, n)


def current(timer=None):
    """``timer``, or where it is None the timer :func:`tracing` installed
    (None when there is none): what an entry point runs its stages on."""
    if timer is None and TRACER is not None:
        return TRACER.timer
    return timer


def record_of(timer) -> StageTimer | None:
    """The :class:`StageTimer` in which :func:`tracing` kept the port's
    spans and counters for ``timer``, a timer without ``count``, or
    None."""
    try:
        return _kept.get(timer)
    except TypeError:
        return None


def stages(timer):
    """The stage opener for ``timer``: ``timer.stage``, and while
    ``timer`` is the installed one, the tallies charged at each boundary
    and the kept record's span beside it; a no-op stage when there is no
    timer."""
    if timer is None:
        return _no_stage
    return functools.partial(_stage, timer)


def _no_stage(_name: str):
    return _NULL


@contextlib.contextmanager
def _stage(timer, name: str):
    tr = TRACER
    if tr is None or tr.timer is not timer:
        with timer.stage(name):
            yield
        return
    _charge(tr)
    with timer.stage(name), (tr.keeper.stage(name) if tr.keeper is not timer else _NULL):
        try:
            yield
        finally:
            _charge(tr)


def _range(name: str):
    """A ``record_function`` range of ``name`` while a ``torch.profiler``
    session is on, else nothing."""
    import torch

    on = getattr(torch.autograd, "_profiler_enabled", None)
    if on is not None and not on():
        return _NULL
    return torch.profiler.record_function(name)


def kernel_ns_per_op(fn: Callable, args: tuple, n_ops: int, iters: int = 20, warmup: int = 2) -> float:
    """Median ns per logical op of ``fn(*args)`` on the card (the
    reference's hrtime.ts analog): after ``warmup`` calls, each of
    ``iters`` calls is timed between two CUDA events and divided by
    ``n_ops``.  Raises without a card."""
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("kernel_ns_per_op times CUDA work: CUDA is not available")
    for _ in range(warmup):
        fn(*args)
    torch.cuda.synchronize()
    samples = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn(*args)
        end.record()
        end.synchronize()
        samples.append(start.elapsed_time(end) * 1e6 / n_ops)
    return statistics.median(samples)
