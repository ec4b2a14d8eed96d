"""Profiling: the port's counterparts of the reference package's
``utils/profiling.py``.

* :func:`trace` - context manager around ``torch.profiler`` (CPU and CUDA
  activity) writing a Chrome trace file (chrome://tracing, Perfetto);
  :func:`device_time` reads such a file: the device's busy time (the
  union of its kernel and copy intervals) and every kernel's time;
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

__all__ = ["Trace", "trace", "device_time", "StageTimer", "stages", "kernel_ns_per_op"]

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
