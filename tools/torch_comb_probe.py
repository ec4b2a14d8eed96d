#!/usr/bin/env python3
"""Time forms of the P-256 comb scan by a team of four lanes (the scan of
``comb_weier`` and ``mul_comb4``, ``zkecdsa_tpu_torch/csrc/comb.cuh``
``comb_weier_row``) on one NVIDIA GPU, at the prover's two calls.

Run from the repository root, on a machine with a card and ``nvcc``:

    python3 tools/torch_comb_probe.py

It compiles a probe library (into ``build/comb_probe``) from
``csrc/comb.cuh`` and one team kernel in five forms:

* ``whole``: ``comb_weier_row`` as the kernels run it: every lane loads
  the whole 108-byte entry (27 words a lane, one request a team);
* ``shared``: lane q loads coordinate q of the entry (lane 3 a copy of
  coordinate 2) and the team shares the three with 27 shuffles;
* ``whole_4``, ``shared_4``: the same under ``__launch_bounds__(128,
  4)``, which caps a thread at 128 registers so that four blocks fit an
  SM;
* ``whole_const``: ``whole`` with the windows a row (32 or 64) a
  compile-time constant, where the other forms take them at run time.

The calls: ``comb_weier`` [256, 81] on the comb table of a parameter
set's h, and ``mul_comb4`` [256, 80] on per-base tables of 256 random
points, both in Montgomery form as the prover builds them.  Every form
must give the wrapper's integers (the plan's geometry).  Prints ptxas'
lines for the probe kernels and one JSON line a call with each form's ms
and the wrapper's (CUDA events, 10 calls after a warm-up) beside the
card's name and power limit.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

FORMS = ("whole", "shared", "whole_4", "shared_4", "whole_const")

PROBE = r"""
#include "comb.cuh"

// comb_weier_row's team scan with the entry loaded a coordinate a lane
template <int E>
__device__ __forceinline__ void row_shared(uint32_t* out, const uint32_t* __restrict__ tab,
                                           const uint8_t* digits, int n, bool live) {
    constexpr int CID = ZK_CURVE_P256;
    constexpr int PT = 3 * ZK_NL;
    const int c = team_lane() < 3 ? team_lane() : 2;
    Digits dg{reinterpret_cast<const uint4*>(digits)};
    Pt<CID> acc, e;
    pt_identity<CID>(acc);
    Fe mine, next;
    fe_load(mine, tab + (long long)dg.next(0) * PT + c * ZK_NL);
#pragma unroll 1
    for (int j = 0; j < n; ++j) {
        const bool more = j + 1 < n;
        if (more) fe_load(next, tab + ((long long)(j + 1) * E + dg.next(j + 1)) * PT + c * ZK_NL);
#pragma unroll
        for (int k = 0; k < 3; ++k) fe_from_lane(e.c[k], mine, k);
        team_weier_add<CID>(acc, acc, e);
        if (more) fe_copy(mine, next);
    }
    team_store<CID>(out, acc, live);
}

// NC > 0: the windows a row a compile-time constant (NC), else n
template <bool SHARED, int E, int MINB, int NC = 0>
__global__ void __launch_bounds__(COMB_THREADS, MINB) probe_kernel(
    long long B, long long S, const uint32_t* __restrict__ tab, long long stride,
    const uint8_t* __restrict__ digits, int n_arg, uint32_t* __restrict__ out) {
    const int n = NC > 0 ? NC : n_arg;
    const long long row = ((long long)blockIdx.x * COMB_THREADS + threadIdx.x) / ZK_TEAM;
    const bool live = row < B;
    const long long i = live ? row : B - 1;
    const uint32_t* t = tab + (i / S) * stride;
    if constexpr (SHARED) {
        row_shared<E>(out + i * 3 * ZK_NL, t, digits + i * n, n, live);
    } else {
        comb_weier_row<ZK_TEAM, E>(out + i * 3 * ZK_NL, t, digits + i * n, n, live);
    }
}

template <int E>
static void launch(int form, long long B, long long S, const uint32_t* tab, long long stride,
                   const uint8_t* d, int n, uint32_t* out, cudaStream_t st) {
    const unsigned blocks = (unsigned)((B * ZK_TEAM + COMB_THREADS - 1) / COMB_THREADS);
    if (form == 0) probe_kernel<false, E, 1><<<blocks, COMB_THREADS, 0, st>>>(B, S, tab, stride, d, n, out);
    if (form == 1) probe_kernel<true, E, 1><<<blocks, COMB_THREADS, 0, st>>>(B, S, tab, stride, d, n, out);
    if (form == 2) probe_kernel<false, E, 4><<<blocks, COMB_THREADS, 0, st>>>(B, S, tab, stride, d, n, out);
    if (form == 3) probe_kernel<true, E, 4><<<blocks, COMB_THREADS, 0, st>>>(B, S, tab, stride, d, n, out);
    if (form == 4) probe_kernel<false, E, 1, E == 256 ? 32 : 64><<<blocks, COMB_THREADS, 0, st>>>(B, S, tab, stride, d, n, out);
}

// entries a window: 256 (comb_weier, one shared table: S = B, stride 0)
// or 16 (mul_comb4, a table a base of S rows)
extern "C" int probe_comb(int form, int entries, long long B, long long S, const void* tab,
                          long long stride, const void* digits, int n, void* out, void* stream) {
    cudaStream_t st = (cudaStream_t)stream;
    const uint32_t* t = (const uint32_t*)tab;
    const uint8_t* d = (const uint8_t*)digits;
    if (entries == 256) launch<256>(form, B, S, t, stride, d, n, (uint32_t*)out, st);
    else launch<16>(form, B, S, t, stride, d, n, (uint32_t*)out, st);
    return (int)cudaGetLastError();
}
"""


def _build() -> ctypes.CDLL:
    from zkecdsa_tpu_torch import _build as zb

    out = ROOT / "build" / "comb_probe"
    out.mkdir(parents=True, exist_ok=True)
    src = out / "comb_probe.cu"
    src.write_text(PROBE)
    lib = out / "libcombprobe.so"
    res = subprocess.run(
        [zb._nvcc(), *zb._NVCC_FLAGS, "-shared", "-I", str(ROOT / "zkecdsa_tpu_torch" / "csrc"),
         str(src), "-o", str(lib)], capture_output=True, text=True)
    report = res.stdout + res.stderr
    for line in report.splitlines():
        if "probe_kernel" in line or "registers" in line or "spill" in line:
            print(line)
    if res.returncode != 0:
        raise RuntimeError("nvcc failed:\n" + report)
    dll = ctypes.CDLL(str(lib))
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    dll.probe_comb.argtypes = [I, I, L, L, P, L, P, I, P, P]
    dll.probe_comb.restype = ctypes.c_int
    return dll


def _ms(fn) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(10):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / 10


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("torch_comb_probe: torch.cuda.is_available() is false", file=sys.stderr)
        return 2
    from zkecdsa_tpu_torch.curves.instances import p256
    from zkecdsa_tpu_torch.ops.curve_ops import comb4_table, comb_table, comb_weier, mul_comb4, p256_ops
    from zkecdsa_tpu_torch.utils import rng
    from zkecdsa_tpu_torch.zkp_attest_list import generate_params_list

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    dll = _build()
    stream = torch.cuda.current_stream().cuda_stream
    rs = np.random.RandomState(9)
    with rng.deterministic(9):
        params = generate_params_list()
    comb = comb_table(p256_ops.pack_points([params.nist_group.h], "cuda")[0])
    G = p256.generator()
    pts = [G.mul(p256.new_scalar(int.from_bytes(rs.bytes(32), "little") % p256.order)) for _ in range(256)]
    tab4 = comb4_table(p256_ops.pack_points(pts, "cuda"))
    d8 = torch.from_numpy(rs.randint(0, 256, size=(256, 81, 32)).astype(np.uint8)).cuda()
    nib = torch.from_numpy(rs.randint(0, 16, size=(256, 80, 64)).astype(np.uint8)).cuda()
    calls = (
        ("comb_weier [256, 81]", lambda: comb_weier(comb, d8), 256, comb.mont, 256 * 81, 256 * 81, 0, d8, 32),
        ("mul_comb4 [256, 80]", lambda: mul_comb4(tab4, nib), 16, tab4, 256 * 80, 80, 64 * 16 * 27, nib, 64),
    )
    for name, wrapper, entries, tab, B, S, stride, dig, n in calls:
        want = wrapper()
        ms = {"wrapper": _ms(wrapper)}
        for k, form in enumerate(FORMS):
            out = torch.empty_like(want)

            def run():
                code = dll.probe_comb(k, entries, B, S, tab.data_ptr(), stride, dig.data_ptr(), n,
                                      out.data_ptr(), stream)
                if code:
                    raise RuntimeError(f"probe_comb: CUDA error {code}")

            ms[form] = _ms(run)
            if not torch.equal(out, want):
                raise AssertionError(f"{name}: form {form} disagrees with the wrapper")
        print(json.dumps(dict(call=name, card=card, ms=ms)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
