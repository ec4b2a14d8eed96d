#!/usr/bin/env python3
"""Time ``ec_add`` (``zkecdsa_tpu_torch/csrc/ec.cu``, a team of four lanes
a pair) beside the one-thread-a-pair kernel it replaced, over batch sizes
on one NVIDIA GPU, both curves.

Run from the repository root, on a machine with a card and ``nvcc``:

    python3 tools/torch_ec_add_sweep.py

It compiles a probe library (into ``build/ec_add_probe``) from
``csrc/ec.cu`` and the one-thread kernel.  For each curve and B (from
the prover's 512 pairs to 406k) it holds both forms exactly against each
other, times each with CUDA events (20 calls after a warm-up) and prints
one JSON line with their ms, beside the card's name and power limit.
``chip_smoke.py`` times the one-thread form beside the shipped kernel
through :func:`one_thread_ec_add`.
"""

from __future__ import annotations

import ctypes
import functools
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

PAIRS = (512, 5069, 10137, 20275, 40550, 51200, 76032, 101376, 152064, 202752, 405504)

# The kernel the team form replaced: one thread a complete add.
PROBE = r"""
#include "ec.cu"

namespace {

template <int CID>
__global__ void one_thread_kernel(long long B,
                                  const uint32_t* __restrict__ P,
                                  const uint32_t* __restrict__ Q,
                                  uint32_t* __restrict__ out) {
    const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= B) return;
    constexpr int C = CurveT<CID>::C;
    Pt<CID> a, b, r;
    pt_load<CID>(a, P + i * C * ZK_NL);
    pt_load<CID>(b, Q + i * C * ZK_NL);
    pt_add<CID>(r, a, b);
    pt_store<CID>(out + i * C * ZK_NL, r);
}

}  // namespace

extern "C" int probe_one_thread_ec_add(int curve, long long B, const void* P, const void* Q,
                                       void* out, void* stream) {
    const int bad = zk_dispatch_curve(curve, [&](auto c) {
        constexpr int CID = decltype(c)::value;
        one_thread_kernel<CID><<<grid_for(B, EC_THREADS), EC_THREADS, 0, (cudaStream_t)stream>>>(
            B, (const uint32_t*)P, (const uint32_t*)Q, (uint32_t*)out);
    });
    return bad ? bad : (int)cudaGetLastError();
}
"""


@functools.lru_cache(maxsize=None)
def build() -> ctypes.CDLL:
    """Compile and load the probe library (once a process); prints
    ptxas' lines for its one-thread kernel."""
    from zkecdsa_tpu_torch import _build as zb

    out = ROOT / "build" / "ec_add_probe"
    out.mkdir(parents=True, exist_ok=True)
    src = out / "ec_add_probe.cu"
    src.write_text(PROBE)
    lib = out / "libecaddprobe.so"
    res = subprocess.run(
        [zb._nvcc(), *zb._NVCC_FLAGS, "-shared", "-I", str(ROOT / "zkecdsa_tpu_torch" / "csrc"),
         str(src), "-o", str(lib)], capture_output=True, text=True)
    report = res.stdout + res.stderr
    lines = report.splitlines()
    for i, line in enumerate(lines):
        if "one_thread_kernel" in line and "Compiling" in line:
            print("\n".join(lines[i : i + 4]))
    if res.returncode != 0:
        raise RuntimeError("nvcc failed:\n" + report)
    dll = ctypes.CDLL(str(lib))
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    dll.probe_one_thread_ec_add.argtypes = [I, L, P, P, P, P]
    return dll


def one_thread_ec_add(ops, P, Q):
    """The one-thread-a-pair form of ``ec_add`` on canonical points
    P, Q [..., C, 9] of one shape on the card (no launch counted)."""
    import torch

    P, Q = P.contiguous(), Q.contiguous()
    out = torch.empty_like(P)
    code = build().probe_one_thread_ec_add(ops.curve_id, P.numel() // (ops.NCOORD * 9), P.data_ptr(),
                                           Q.data_ptr(), out.data_ptr(), torch.cuda.current_stream().cuda_stream)
    if code:
        raise RuntimeError(f"probe_one_thread_ec_add: CUDA error {code}")
    return out


def _ms(fn) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(20):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / 20


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("torch_ec_add_sweep: torch.cuda.is_available() is false", file=sys.stderr)
        return 2
    from zkecdsa_tpu_torch.curves.instances import p256, tomEdwards256
    from zkecdsa_tpu_torch.ops.curve_ops import ec_add, p256_ops, tom_ops

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    build()
    rs = np.random.RandomState(12)
    rows = []
    for ops, g in ((p256_ops, p256), (tom_ops, tomEdwards256)):
        pool = ops.pack_points(
            [g.generator().mul(g.new_scalar(int.from_bytes(rs.bytes(32), "little") % g.order)) for _ in range(64)],
            "cuda")
        for B in PAIRS:
            idx = torch.arange(B, device="cuda") % 64
            P, Q = pool[idx], pool[(idx * 7 + 3) % 64]
            if not torch.equal(ec_add(ops, P, Q), one_thread_ec_add(ops, P, Q)):
                raise AssertionError(f"{g.name} B={B}: the two forms disagree")
            rows.append(dict(curve=g.name, B=B, thread_ms=_ms(lambda: one_thread_ec_add(ops, P, Q)),
                             team_ms=_ms(lambda: ec_add(ops, P, Q))))
            print(json.dumps(rows[-1]), flush=True)
    print(json.dumps(dict(card=card, rows=rows)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
