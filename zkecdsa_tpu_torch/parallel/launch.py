"""Start the ranks of a mesh as local processes.

``run(fn, world_size)`` spawns ``world_size`` processes (the ``spawn``
start method: a parent that already holds a CUDA context cannot fork
one), joins them into one ``torch.distributed`` process group through a
``FileStore`` in a temporary directory (no TCP port), calls
``fn(rank, world_size, *args)`` in each, and returns the results by rank.
The join has its own deadline: a rank that raises, dies or outlives it
fails the run, and the other ranks are terminated rather than left waiting
in a collective.  ``fn`` and its results cross the process boundary by
pickle, so ``fn`` must be a module-level function of an importable module.
"""

from __future__ import annotations

import datetime
import multiprocessing
import queue
import shutil
import tempfile
import time
import traceback
from pathlib import Path

__all__ = ["run"]


def _worker(rank, world, backend, store_path, timeout, fn, args, results) -> None:
    import torch.distributed as dist

    try:
        dist.init_process_group(
            backend, store=dist.FileStore(store_path, world), rank=rank, world_size=world,
            timeout=datetime.timedelta(seconds=timeout),
        )
        try:
            out = fn(rank, world, *args)
        finally:
            dist.destroy_process_group()
    except Exception:
        results.put((rank, False, traceback.format_exc()))
    else:
        results.put((rank, True, out))


def run(fn, world_size: int, *, args: tuple = (), backend: str = "gloo",
        timeout: float = 600.0) -> list:
    """Every rank's ``fn(rank, world_size, *args)``, by rank.  ``timeout``
    (seconds) bounds both the process group's collectives and the join.
    Raises RuntimeError with the tracebacks if a rank raised, if one died,
    or at the deadline."""
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    tmpdir = tempfile.mkdtemp(prefix="zk-mesh-")
    store = str(Path(tmpdir) / "store")
    procs = [
        ctx.Process(target=_worker, args=(r, world_size, backend, store, timeout, fn, args, results))
        for r in range(world_size)
    ]
    deadline = time.monotonic() + timeout
    out, errors = {}, {}
    try:
        for p in procs:
            p.start()
        while len(out) < world_size and not errors:
            left = deadline - time.monotonic()
            if left <= 0:
                missing = sorted(set(range(world_size)) - set(out))
                raise RuntimeError(f"ranks {missing} did not finish before the deadline")
            try:
                rank, ok, payload = results.get(timeout=min(left, 1.0))
            except queue.Empty:
                dead = {r: p.exitcode for r, p in enumerate(procs) if p.exitcode not in (None, 0)}
                if dead:
                    raise RuntimeError(f"ranks died without a result (exit codes {dead})") from None
                continue
            (out if ok else errors)[rank] = payload
        if errors:
            raise RuntimeError("\n".join(f"rank {r} raised:\n{tb}" for r, tb in sorted(errors.items())))
        return [out[r] for r in range(world_size)]
    finally:
        failed = len(out) < world_size
        for p in procs:
            if failed and p.is_alive():  # it may wait in a collective forever
                p.terminate()
            if p.pid is not None:
                p.join(10)
                if p.is_alive():
                    p.kill()
                    p.join()
        shutil.rmtree(tmpdir, ignore_errors=True)
