#!/usr/bin/env python3
"""Time the port's ``to_affine`` kernel over forced group sizes, at the
main path's six shapes, on one NVIDIA GPU.

Run from the repository root, on a machine with a card and ``nvcc``:

    python3 tools/torch_affine_sweep.py [out.json]

For each shape (the prover's P-256 [256, 163] and Tom-256 [256, 162],
[10240, 39], [12288]; the verifier's [256, 20, 2] on both
curves) it builds random canonical coordinates from a seed (to_affine is
field arithmetic: the points need not lie on the curve; one Z in 97 is
zero), holds the kernel under ``affine_plan``'s group against the plain
version exactly, then times the kernel with CUDA events at each group
size of ``GROUPS`` and at the plan's, and prints one JSON line a shape
(and writes them all to ``out.json`` when given), with the card's name
and power limit, the resident warps of the kernel and ``affine_threads``.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

GROUPS = (1, 2, 3, 4, 6, 8, 12, 16, 24, 32, 48, 64)
SHAPES = (
    ("p256", (256, 163)), ("tomEdwards256", (256, 162)),
    ("tomEdwards256", (10240, 39)), ("tomEdwards256", (12288,)),
    ("p256", (256, 20, 2)), ("tomEdwards256", (256, 20, 2)),
)
SEED = 2024


def _ms(fn, reps: int = 10) -> float:
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


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("torch_affine_sweep: torch.cuda.is_available() is false", file=sys.stderr)
        return 2
    from zkecdsa_tpu_torch import _build
    from zkecdsa_tpu_torch.ops import curve_ops as tc

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    _build.load()
    dev = torch.device("cuda")
    rs = np.random.RandomState(SEED)
    ops_by = {"p256": tc.p256_ops, "tomEdwards256": tc.tom_ops}
    lines = []
    for name, shape in SHAPES:
        ops = ops_by[name]
        f = ops.f
        B = int(np.prod(shape))
        vals = [int.from_bytes(rs.bytes(40), "little") % f.p for _ in range(B * ops.NCOORD)]
        P = f.pack(vals, dev).reshape(*shape, ops.NCOORD, -1)
        P.view(-1, ops.NCOORD, P.shape[-1])[::97, -1] = 0
        threads = tc.affine_threads(ops, dev)
        plan = tc.affine_plan(B, threads)
        got, want = tc.to_affine(ops, P), ops.to_affine(P)
        if not all(torch.equal(a, b) for a, b in zip(got, want)):
            raise AssertionError(f"to_affine {name} {list(shape)}: kernel disagrees with its plain version")
        ms = {g: _ms(lambda: tc.to_affine(ops, P, group=g)) for g in sorted(set(GROUPS) | {plan.group})}
        best = min(ms, key=ms.get)
        rec = dict(curve=name, shape=list(shape), points=B, card=card, affine_threads=threads,
                   resident_warps=tc._resident_warps("zk_to_affine_resident_warps", tc._index(dev), ops.curve_id),
                   plan_group=plan.group, plan_ms=ms[plan.group], best_group=best, best_ms=ms[best],
                   ms_by_group=ms)
        lines.append(rec)
        print(json.dumps(rec), flush=True)
    if len(sys.argv) > 1:
        Path(sys.argv[1]).write_text("\n".join(json.dumps(r) for r in lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
