#!/usr/bin/env python3
"""Time the forms of the Pippenger bucket kernels
(``zkecdsa_tpu_torch/csrc/bucket.cu``) on one NVIDIA GPU, at the bucket
backend's three shapes: the verifier's per-row P-256 MSM [256, 48] w=5,
the Tom-256 attribution MSM [256, 760] w=5 and the combined Tom-256 width
[16, 8192] w=6.

Run from the repository root, on a machine with a card and ``nvcc``:

    python3 tools/torch_bucket_probe.py [out.json]

It compiles a probe library (into ``build/bucket_probe``) from the shipped
``csrc/bucket.cu`` and ``tools/bucket_old.cu`` (the kernels before the
redesign) in one translation unit, and times, with CUDA events over 5-20
calls after a warm-up:

* ``sums_old``: the old ``bucket_sums`` (a thread a bucket, every term
  converted in every window, every bucket from the identity, O(B*T)
  lists); ``sums_old_first``: the same, each bucket from its first term;
  ``sums_old_first_raw``: also without the conversions;
* ``sums_lane``, ``sums_team``: the shipped kernel (those two steps, the
  O(T) counting sort) with a lane or a team of four lanes a bucket
  (``sums_team`` only up to 64 buckets); ``sums_plan``: the wrapper, on
  :func:`bucket_plan`'s choice;
* ``fold_old``: the old ``bucket_fold`` (a thread a window, thread 0's
  Horner); ``fold_s<k>``: the shipped kernel at k segments a window
  (1, 2, 4, 8, 16, 32 up to B - 1), one window a team; ``fold_s1_w<t>``:
  one segment, t windows a team (2 and 4: fewer blocks a row);
  ``fold_plan``: the wrapper.

Every form must equal the plain versions as group elements (on the
first rows, as chip_smoke.py does).  Prints ptxas' lines for the probe's
kernels, each shape's line, and one JSON line with every form's ms, the
plan, the card's name and power limit; ``out.json`` gets the same.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

# (curve, rows, terms, window, rows held against the plain versions)
SHAPES = (("p256", 256, 48, 5, 16), ("tomEdwards256", 256, 760, 5, 4),
          ("tomEdwards256", 16, 8192, 6, 2))
SEGS = (1, 2, 4, 8, 16, 32)

PROBE = r"""
#include "bucket.cu"
#include "bucket_old.cu"
"""


@functools.lru_cache(maxsize=None)
def build() -> ctypes.CDLL:
    """Compile and load the probe library (once a process); prints
    ptxas' lines for its kernels."""
    from zkecdsa_tpu_torch import _build as zb

    out = ROOT / "build" / "bucket_probe"
    out.mkdir(parents=True, exist_ok=True)
    src = out / "bucket_probe.cu"
    src.write_text(PROBE)
    lib = out / "libbucketprobe.so"
    res = subprocess.run(
        [zb._nvcc(), *zb._NVCC_FLAGS, "-shared", "-I", str(ROOT / "zkecdsa_tpu_torch" / "csrc"),
         "-I", str(ROOT / "tools"), str(src), "-o", str(lib)], capture_output=True, text=True)
    report = res.stdout + res.stderr
    for line in report.splitlines():
        if "bucket" in line or "registers" in line or "spill" in line:
            print(line)
    if res.returncode != 0:
        raise RuntimeError("nvcc failed:\n" + report)
    dll = ctypes.CDLL(str(lib))
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    dll.probe_old_bucket_sums.argtypes = [I, I, I, L, L, I, I, P, P, P, P]
    dll.probe_old_bucket_fold.argtypes = [I, L, I, I, I, P, P, P]
    dll.zk_bucket_sums.argtypes = [I, I, L, L, I, I, P, P, P, P]
    dll.zk_bucket_fold.argtypes = [I, L, I, I, I, I, I, I, P, P, P, P, P]
    return dll


def _ms(fn, reps: int) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def _check(code: int, what: str) -> None:
    if code:
        raise RuntimeError(f"{what}: CUDA error {code}")


def _inputs(ops, g, R, T, rs, dev):
    """R rows of T random points (each a random projective representative
    of one of 64 host points) and scalars, an identity point with scalar 0
    at the end of each row."""
    import torch

    G = g.generator()
    host = [G.mul(g.new_scalar(int.from_bytes(rs.bytes(32), "little") % g.order)) for _ in range(64)]
    p = ops.f.p
    coords = []
    for i in range(R * T):
        lam = int.from_bytes(rs.bytes(40), "little") % (p - 1) + 1
        coords.extend(c * lam % p for c in ops._host_coords(host[i % 64]))
    P = ops.f.pack(coords, dev).reshape(R, T, ops.NCOORD, -1)
    P[:, -1] = ops.identity((), dev)
    scs = [[int.from_bytes(rs.bytes(32), "little") % g.order for _ in range(T)] for _ in range(R)]
    for row in scs:
        row[-1] = 0
    return P.contiguous(), scs, torch


def _same(ops, a, b) -> bool:
    import torch

    return all(torch.equal(x, y) for x, y in zip(ops.to_affine(a), ops.to_affine(b)))


def probe_shape(dll, name, R, T, w, rows, rs) -> dict:
    import numpy as np  # noqa: F401  (numpy backs window_digits)

    from zkecdsa_tpu_torch.curves.instances import p256, tomEdwards256
    from zkecdsa_tpu_torch.ops.curve_ops import p256_ops, tom_ops
    from zkecdsa_tpu_torch.ops.field import NLIMBS
    from zkecdsa_tpu_torch.ops.msm_bucket import (
        bucket_fold,
        bucket_fold_plain,
        bucket_plan,
        bucket_sums,
        bucket_sums_plain,
        bucket_teams,
        n_windows,
        window_digits,
    )

    ops, g = {"p256": (p256_ops, p256), "tomEdwards256": (tom_ops, tomEdwards256)}[name]
    dev = "cuda"
    P, scs, torch = _inputs(ops, g, R, T, rs, dev)
    D, B = n_windows(w), 1 << w
    dig = torch.from_numpy(window_digits(scs, T, w)).to(dev).contiguous()
    stream = torch.cuda.current_stream().cuda_stream
    want_S = bucket_sums_plain(ops, P[:rows], dig[:rows], w)
    plan = bucket_plan(ops, R, w, bucket_teams(ops, dev))
    ms: dict[str, float] = {}
    reps = 5 if R * T > 100000 else 10
    S = torch.empty((R, D, B, ops.NCOORD, NLIMBS), dtype=torch.int32, device=dev)

    def old_sums(first, convert):
        _check(dll.probe_old_bucket_sums(ops.curve_id, first, convert, R, T, D, B, P.data_ptr(),
                                         dig.data_ptr(), S.data_ptr(), stream), "probe_old_bucket_sums")

    for key, first, convert in (("sums_old", 0, 1), ("sums_old_first", 1, 1), ("sums_old_first_raw", 1, 0)):
        old_sums(first, convert)
        if not _same(ops, S[:rows], want_S):
            raise AssertionError(f"{key} {name} [{R}, {T}] disagrees with the plain bucket sums")
        ms[key] = _ms(lambda: old_sums(first, convert), reps)

    def new_sums(lanes):
        _check(dll.zk_bucket_sums(ops.curve_id, lanes, R, T, D, B, P.data_ptr(), dig.data_ptr(),
                                  S.data_ptr(), stream), "zk_bucket_sums")

    for lanes in (1, 4) if B <= 64 else (1,):
        key = "sums_lane" if lanes == 1 else "sums_team"
        new_sums(lanes)
        if not _same(ops, S[:rows], want_S):
            raise AssertionError(f"{key} {name} [{R}, {T}] disagrees with the plain bucket sums")
        ms[key] = _ms(lambda: new_sums(lanes), reps)
    got = bucket_sums(ops, P, dig, w)
    if not _same(ops, got[:rows], want_S):
        raise AssertionError(f"bucket_sums {name} [{R}, {T}] disagrees with the plain bucket sums")
    ms["sums_plan"] = _ms(lambda: bucket_sums(ops, P, dig, w), reps)

    # the folds, on the shipped sums of every row
    S = got
    want = bucket_fold_plain(ops, S[:rows], w)
    out = torch.empty((R, ops.NCOORD, NLIMBS), dtype=torch.int32, device=dev)

    def old_fold():
        _check(dll.probe_old_bucket_fold(ops.curve_id, R, D, B, w, S.data_ptr(), out.data_ptr(), stream),
               "probe_old_bucket_fold")

    old_fold()
    if not _same(ops, out[:rows], want):
        raise AssertionError(f"fold_old {name} [{R}, {T}] disagrees with the plain fold")
    ms["fold_old"] = _ms(old_fold, reps)
    wsum = torch.empty((R, D, ops.NCOORD, NLIMBS), dtype=torch.int32, device=dev)
    ticket = torch.zeros((R,), dtype=torch.int32, device=dev)
    forms = [(s, 1, f"fold_s{s}") for s in SEGS if s <= B - 1] + [(1, t, f"fold_s1_w{t}") for t in (2, 4)]
    for segs, wpt, key in forms:
        forced = bucket_plan(ops, R, w, 0, segs=segs, wpt=wpt)

        def new_fold():
            _check(dll.zk_bucket_fold(ops.curve_id, R, D, B, w, segs, wpt, forced.groups, S.data_ptr(),
                                      wsum.data_ptr(), ticket.data_ptr(), out.data_ptr(), stream),
                   "zk_bucket_fold")

        new_fold()
        if not _same(ops, out[:rows], want):
            raise AssertionError(f"{key} {name} [{R}, {T}] disagrees with the plain fold")
        ms[key] = _ms(new_fold, reps)
    got = bucket_fold(ops, S, w)
    if not _same(ops, got[:rows], want):
        raise AssertionError(f"bucket_fold {name} [{R}, {T}] disagrees with the plain fold")
    ms["fold_plan"] = _ms(lambda: bucket_fold(ops, S, w), reps)
    line = dict(call=f"{name} [{R}, {T}] w={w}", plan=dataclasses.asdict(plan), ms=ms)
    print(json.dumps(line), flush=True)
    return line


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("torch_bucket_probe: torch.cuda.is_available() is false", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    dll = build()
    rs = np.random.RandomState(13)
    lines = [probe_shape(dll, *shape, rs) for shape in SHAPES]
    result = dict(card=card, shapes=lines)
    print(json.dumps(result), flush=True)
    if len(sys.argv) > 1:
        Path(sys.argv[1]).parent.mkdir(parents=True, exist_ok=True)
        Path(sys.argv[1]).write_text(json.dumps(result, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
