"""The device trace of a traced run: ``torch.profiler`` (CPU and CUDA
activity, CUPTI) over the traced batches, written as a Chrome trace file
under ``TMPDIR`` and reduced here to what the per-layer metrics and the
``breakdown`` read:

* ``busy_s``: the union of the device's kernel, copy and set intervals
  (overlaps counted once), as the port's ``utils/profiling.device_time``
  computes it;
* ``window_s``: from the first traced batch's start to the last's end;
* ``kernel_s``: the summed time of every kernel, and each kernel's by
  name;
* idle seconds: the window's time in which no device operation ran,
  charged to the innermost host span (``record_function`` range) open at
  the time.
"""

from __future__ import annotations

import bisect
import dataclasses
import json
import os
import re
import tempfile
from collections import defaultdict

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


@dataclasses.dataclass
class DeviceTrace:
    busy_s: float
    window_s: float
    kernel_s: float
    kernels: dict  # short kernel name -> seconds
    idle: dict  # host span name -> idle seconds in the window


def kernel_name(full: str) -> str:
    """A kernel's function name from the demangled signature a trace
    gives (``void (anonymous namespace)::f_kernel<3, 64>(int, ...)`` ->
    ``f_kernel``)."""
    s = full.replace("(anonymous namespace)::", "")
    depth, out = 0, []
    for ch in s:  # drop template arguments
        if ch == "<":
            depth += 1
        elif ch == ">" and depth:
            depth -= 1
        elif not depth:
            out.append(ch)
    head = "".join(out).split("(", 1)[0].split()
    return head[-1].split("::")[-1] if head else full


def capture():
    """A ``torch.profiler.profile`` of CPU and CUDA activity, and the
    path its Chrome trace is to be written to (under ``TMPDIR``)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fd, path = tempfile.mkstemp(prefix="zkbench-trace-", suffix=".json")
    os.close(fd)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    return profile(activities=activities), path


def read(path: str, window_span: str) -> DeviceTrace:
    """Reduce the Chrome trace at ``path``: the window is the union of the
    host ranges named ``window_span`` (one a traced batch)."""
    with open(path) as fh:
        events = json.load(fh)
    events = events.get("traceEvents", []) if isinstance(events, dict) else events
    dev, ranges, kernels = [], [], defaultdict(float)
    for ev in events:
        if ev.get("ph") != "X":
            continue
        cat = ev.get("cat")
        t0, dur = float(ev["ts"]), float(ev.get("dur", 0.0))
        if cat in DEVICE_CATS:
            dev.append((t0, t0 + dur))
            if cat == "kernel":
                kernels[kernel_name(ev.get("name", ""))] += dur * 1e-6
        elif cat == "user_annotation":
            ranges.append((t0, t0 + dur, ev.get("name", "")))
    win = [(a, b) for a, b, name in ranges if name == window_span]
    if not win:
        raise RuntimeError(f"the trace {path} has no range {window_span!r}")
    lo, hi = min(a for a, _ in win), max(b for _, b in win)
    merged: list[list[float]] = []
    for a, b in sorted(dev):
        a, b = max(a, lo), min(b, hi)
        if b <= a:
            continue
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    busy = sum(b - a for a, b in merged)
    idle = _idle_by_span(merged, [(max(a, lo), min(b, hi), n) for a, b, n in ranges if b > lo and a < hi], lo, hi)
    return DeviceTrace(
        busy_s=busy * 1e-6, window_s=(hi - lo) * 1e-6, kernel_s=sum(kernels.values()),
        kernels=dict(kernels), idle=idle,
    )


def _idle_by_span(merged: list, ranges: list, lo: float, hi: float) -> dict:
    """Seconds of [lo, hi) in which no device interval of ``merged``
    (sorted, disjoint) ran, each charged to the innermost host range open
    at the time (the shortest one covering it)."""
    starts = [a for a, _ in merged]
    ends = [b for _, b in merged]
    done = [0.0]  # device time before each interval
    for a, b in merged:
        done.append(done[-1] + b - a)

    def busy_before(t: float) -> float:
        i = bisect.bisect_right(starts, t)
        return done[i] - (max(0.0, ends[i - 1] - t) if i else 0.0)

    cuts = sorted({lo, hi} | {t for a, b, _ in ranges for t in (a, b)})
    inner = sorted(ranges, key=lambda r: r[1] - r[0])
    idle: dict = defaultdict(float)
    for a, b in zip(cuts, cuts[1:]):
        if b <= a:
            continue
        name = next((n for s, e, n in inner if s <= a and b <= e), "outside any span")
        gap = (b - a) - (busy_before(b) - busy_before(a))
        if gap > 0:
            idle[name] += gap * 1e-6
    return dict(idle)
