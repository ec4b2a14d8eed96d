"""Host spans of a traced run.

:class:`Spans` is the stage timer the benchmark hands to the port's entry
points through their ``timer=`` argument (they call ``timer.stage(name)``
around each host and device stage), and it also times the benchmark's own
spans around the calls into each layer (``serde``, ``device_params``,
``batch``).  Each span:

* synchronises the card at its start and end where ``sync`` is set, as the
  port's ``StageTimer`` does, so a stage's seconds are its own work's and
  not the time to enqueue it;
* opens a ``torch.profiler.record_function`` range of its name, so the
  device trace can say what the host was doing in each idle gap;
* nests: a span opened inside another is its child, and each span's self
  time (its seconds less its children's) is kept by name and by batch.

Untraced runs pass no timer: the entry points then open no stage at all.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict


class Spans:
    def __init__(self, sync=None, record=True) -> None:
        self._sync = sync  # a callable that waits for the card, or None
        self._record = record
        self._stack: list[list] = []  # [name, start, child seconds]
        self.batch = None  # the batch the spans are charged to
        self.self_s: dict = defaultdict(float)  # (batch, name) -> self seconds
        self.parents: dict = {}  # name -> the name of the span it nested in

    @contextlib.contextmanager
    def stage(self, name: str):
        if self._sync is not None:
            self._sync()
        rf = contextlib.nullcontext()
        if self._record:
            import torch

            rf = torch.profiler.record_function(name)
        with rf:
            frame = [name, time.perf_counter(), 0.0]
            if self._stack:
                self.parents.setdefault(name, self._stack[-1][0])
            self._stack.append(frame)
            try:
                yield
            finally:
                if self._sync is not None:
                    self._sync()
                dt = time.perf_counter() - frame[1]
                self._stack.pop()
                if self._stack:
                    self._stack[-1][2] += dt
                key = (self.batch, name)
                self.self_s[key] += dt - frame[2]

    def per_batch(self, names, batches) -> float | None:
        """Self seconds of the spans ``names``, summed, a batch of
        ``batches``; None where none of them was opened."""
        hit = [k for k in self.self_s if k[1] in names and k[0] in batches]
        if not hit or not batches:
            return None
        return sum(self.self_s[k] for k in hit) / len(batches)
