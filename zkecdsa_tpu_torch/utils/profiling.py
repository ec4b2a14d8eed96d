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
* :class:`StageTimer` - per-stage wall-clock accounting for the batched
  pipeline.  Work on a CUDA device is asynchronous, so with a CUDA
  ``device`` each stage boundary synchronises it: a stage's time is then
  the time its own work took on the card, not the time to enqueue it;
* :func:`kernel_ns_per_op` - median ns per logical op of a call on the
  card, timed with CUDA events.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import statistics
import time
from typing import Callable

import torch

__all__ = [
    "Trace", "trace", "device_time", "kernel_launch_us", "case_launch_us", "kernel_device_ms", "StageTimer", "stages",
    "kernel_ns_per_op",
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


class StageTimer:
    """Accumulates wall-clock per named pipeline stage."""

    def __init__(self, device: torch.device | str | None = None) -> None:
        self.stages: dict[str, float] = {}
        self.counts: dict[str, int] = {}
        dev = torch.device(device) if device is not None else None
        self._sync = dev is not None and dev.type == "cuda"
        self._device = dev

    def _barrier(self) -> None:
        if self._sync:
            torch.cuda.synchronize(self._device)

    @contextlib.contextmanager
    def stage(self, name: str):
        self._barrier()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self._barrier()
            dt = time.perf_counter() - t0
            self.stages[name] = self.stages.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def report(self) -> str:
        total = sum(self.stages.values()) or 1.0
        lines = [
            f"{name:<28s} {secs:8.3f}s  {100 * secs / total:5.1f}%  x{self.counts[name]}"
            for name, secs in sorted(
                self.stages.items(), key=lambda kv: -kv[1]
            )
        ]
        return "\n".join(lines)

    def as_json(self) -> str:
        return json.dumps(self.stages)


def stages(timer: StageTimer | None):
    """``timer.stage``, or a no-op stage when there is no timer."""
    return timer.stage if timer is not None else (lambda _name: contextlib.nullcontext())


def kernel_ns_per_op(fn: Callable, args: tuple, n_ops: int, iters: int = 20, warmup: int = 2) -> float:
    """Median ns per logical op of ``fn(*args)`` on the card (the
    reference's hrtime.ts analog): after ``warmup`` calls, each of
    ``iters`` calls is timed between two CUDA events and divided by
    ``n_ops``.  Raises without a card."""
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
