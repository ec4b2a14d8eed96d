"""The benchmark of zkecdsa_tpu_torch on NVIDIA cards: one run of one
cell.

    python3 zkbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout.  The cell, its configuration and its
traffic mix are found by name through ``BENCHMARK.json``.  The last line
of standard output is the result (JSON); progress and, last, each number
the correctness check compared beside its limit go to standard error.
Without the cell's cards it prints no result and exits 2; if a module of
JAX or of the JAX package is loaded once the window has closed, it exits 3.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    # every build and kernel cache at a fixed path inside the checkout
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(ROOT / "build" / "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "triton"))
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    from zkbench.harness import cell

    try:
        out = cell.run(args.workload, args.seed, args.seconds, bool(args.trace), t_start=T_START, root=ROOT)
    except cell.NoDevice as exc:
        print(f"zkbench: {exc}", file=sys.stderr)
        return 2
    found = out.pop("forbidden_modules")
    if found:
        print(f"zkbench: the run loaded {', '.join(found)}; the benchmark may load neither JAX nor the JAX package",
              file=sys.stderr)
        return 3
    for name, c in out["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})", file=sys.stderr)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
