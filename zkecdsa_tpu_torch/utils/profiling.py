"""Per-stage wall-clock accounting for the batched pipeline.

:class:`StageTimer` is the port's counterpart of the reference package's
timer.  Work on a CUDA device is asynchronous, so with a CUDA ``device``
each stage boundary synchronises it: a stage's time is then the time its
own work took on the card, not the time to enqueue it.
"""

from __future__ import annotations

import contextlib
import json
import time

import torch

__all__ = ["StageTimer", "stages"]


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
