#!/usr/bin/env python3
"""Time four forms of the Fermat inverse a^(p-2) of the port's CUDA field
code on one NVIDIA GPU, one inverse a thread.

Run from the repository root, on a machine with a card and ``nvcc``:

    python3 tools/torch_inv_probe.py

It compiles a probe library (into ``build/inv_probe``) from
``zkecdsa_tpu_torch/csrc/field.cuh`` and four inverse kernels:

* ``ladder``: the bit ladder, 288 squarings and a product a set bit of
  p - 2 (the chain ``to_affine`` ran an inverse a point on);
* ``window_local``: ``fe_inv`` as the kernels call it, a fixed 4-bit
  window whose table a^1..a^15 is indexed by the digit at run time
  (local memory);
* ``window_unrolled``: ``fe_inv``'s window with its four squarings a
  digit unrolled (five inlined products in the loop, not two);
* ``window_regs``: the window with the table indexed only by constants
  (a ``switch`` on the digit), so it can stay in registers; squarings
  unrolled.

Each runs on the P-256 and the Tom-256 prime at 1280, 10240, 16896 and
67584 threads (blocks of 128); all must give the same integers (and
Python's ``pow`` on the first rows).  Prints ptxas' lines for the probe
kernels and one JSON line a (modulus, threads) with each form's ms (CUDA
events, 10 calls after a warm-up) and the card's name and power limit.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

FORMS = ("ladder", "window_local", "window_unrolled", "window_regs")
THREADS = (1280, 10240, 16896, 67584)

PROBE = r"""
#include "field.cuh"

__device__ __forceinline__ void inv_ladder(Fe r, const Fe a, const ZkModulus& M) {
    uint32_t e[ZK_NL];
#pragma unroll
    for (int i = 0; i < ZK_NL; ++i) e[i] = M.p[i];
    e[0] -= 2u;
    Fe acc;
    fe_copy(acc, M.one);
    for (int i = ZK_NL * 32 - 1; i >= 0; --i) {
        fe_mont_mul(acc, acc, acc, M);
        if ((e[i >> 5] >> (i & 31)) & 1u) fe_mont_mul(acc, acc, a, M);
    }
    fe_copy(r, acc);
}

__device__ __forceinline__ void inv_window_unrolled(Fe r, const Fe a, const ZkModulus& M) {
    Fe tab[16];
    fe_copy(tab[1], a);
#pragma unroll 1
    for (int k = 2; k < 16; ++k) fe_mont_mul(tab[k], tab[k - 1], a, M);
    auto digit = [&](int i) {
        const uint32_t w = (i >> 3) ? M.p[i >> 3] : M.p[0] - 2u;
        return (w >> ((i & 7) * 4)) & 15u;
    };
    int i = ZK_NL * 8 - 1;
    while (digit(i) == 0u) --i;
    Fe acc;
    fe_copy(acc, tab[digit(i)]);
#pragma unroll 1
    for (--i; i >= 0; --i) {
#pragma unroll
        for (int s = 0; s < 4; ++s) fe_mont_mul(acc, acc, acc, M);
        const uint32_t d = digit(i);
        if (d != 0u) fe_mont_mul(acc, acc, tab[d], M);
    }
    fe_copy(r, acc);
}

#define ZK_CASE(k) case k: fe_mont_mul(acc, acc, tab[k], M); break;
#define ZK_SEL(k) case k: fe_copy(acc, tab[k]); break;
__device__ __forceinline__ void inv_window_regs(Fe r, const Fe a, const ZkModulus& M) {
    Fe tab[16];
    fe_copy(tab[1], a);
#pragma unroll
    for (int k = 2; k < 16; ++k) fe_mont_mul(tab[k], tab[k - 1], a, M);
    auto digit = [&](int i) {
        const uint32_t w = (i >> 3) ? M.p[i >> 3] : M.p[0] - 2u;
        return (w >> ((i & 7) * 4)) & 15u;
    };
    int i = ZK_NL * 8 - 1;
    while (digit(i) == 0u) --i;
    Fe acc;
    switch (digit(i)) {
        ZK_SEL(1) ZK_SEL(2) ZK_SEL(3) ZK_SEL(4) ZK_SEL(5) ZK_SEL(6) ZK_SEL(7) ZK_SEL(8)
        ZK_SEL(9) ZK_SEL(10) ZK_SEL(11) ZK_SEL(12) ZK_SEL(13) ZK_SEL(14) ZK_SEL(15)
        default: break;
    }
#pragma unroll 1
    for (--i; i >= 0; --i) {
#pragma unroll
        for (int s = 0; s < 4; ++s) fe_mont_mul(acc, acc, acc, M);
        switch (digit(i)) {
            ZK_CASE(1) ZK_CASE(2) ZK_CASE(3) ZK_CASE(4) ZK_CASE(5) ZK_CASE(6) ZK_CASE(7)
            ZK_CASE(8) ZK_CASE(9) ZK_CASE(10) ZK_CASE(11) ZK_CASE(12) ZK_CASE(13) ZK_CASE(14)
            ZK_CASE(15)
            default: break;
        }
    }
    fe_copy(r, acc);
}

template <int V, int MOD>
__global__ void __launch_bounds__(128) inv_kernel(long long n, const uint32_t* in, uint32_t* out) {
    const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    const ZkModulus& M = ZK_MODS[MOD];
    Fe a, m, r, s;
    fe_load(a, in + i * ZK_NL);
    fe_to_mont(m, a, M);
    if (V == 0) inv_ladder(r, m, M);
    if (V == 1) fe_inv(r, m, M);
    if (V == 2) inv_window_unrolled(r, m, M);
    if (V == 3) inv_window_regs(r, m, M);
    fe_from_mont(s, r, M);
    fe_store(out + i * ZK_NL, s);
}

template <int V>
static void launch(int mod, long long n, const uint32_t* in, uint32_t* out, cudaStream_t st) {
    const unsigned blocks = (unsigned)((n + 127) / 128);
    if (mod == ZK_P256_P) inv_kernel<V, ZK_P256_P><<<blocks, 128, 0, st>>>(n, in, out);
    else inv_kernel<V, ZK_TOM_P><<<blocks, 128, 0, st>>>(n, in, out);
}

extern "C" int probe_inv(int form, int mod, long long n, const void* in, void* out, void* stream) {
    cudaStream_t st = (cudaStream_t)stream;
    const uint32_t* x = (const uint32_t*)in;
    uint32_t* y = (uint32_t*)out;
    if (form == 0) launch<0>(mod, n, x, y, st);
    else if (form == 1) launch<1>(mod, n, x, y, st);
    else if (form == 2) launch<2>(mod, n, x, y, st);
    else launch<3>(mod, n, x, y, st);
    return (int)cudaGetLastError();
}
"""


def _build() -> ctypes.CDLL:
    from zkecdsa_tpu_torch import _build as zb

    out = ROOT / "build" / "inv_probe"
    out.mkdir(parents=True, exist_ok=True)
    src = out / "inv_probe.cu"
    src.write_text(PROBE)
    lib = out / "libinvprobe.so"
    res = subprocess.run(
        [zb._nvcc(), *zb._NVCC_FLAGS, "-shared", "-I", str(ROOT / "zkecdsa_tpu_torch" / "csrc"),
         str(src), "-o", str(lib)], capture_output=True, text=True)
    report = res.stdout + res.stderr
    for line in report.splitlines():
        if "inv_kernel" in line or "registers" in line or "stack" in line:
            print(line)
    if res.returncode != 0:
        raise RuntimeError("nvcc failed:\n" + report)
    dll = ctypes.CDLL(str(lib))
    dll.probe_inv.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p,
                              ctypes.c_void_p, ctypes.c_void_p]
    dll.probe_inv.restype = ctypes.c_int
    return dll


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("torch_inv_probe: torch.cuda.is_available() is false", file=sys.stderr)
        return 2
    from zkecdsa_tpu_torch.ops.field import P256_P, TOM_P

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    dll = _build()
    rs = np.random.RandomState(7)
    stream = torch.cuda.current_stream().cuda_stream
    for f in (P256_P, TOM_P):
        n_max = max(THREADS)
        vals = [int.from_bytes(rs.bytes(40), "little") % f.p for _ in range(n_max)]
        x = f.pack(vals, "cuda")
        for n in THREADS:
            outs, ms = {}, {}
            for k, form in enumerate(FORMS):
                y = torch.empty_like(x[:n])

                def run():
                    code = dll.probe_inv(k, f.mod_id, n, x.data_ptr(), y.data_ptr(), stream)
                    if code:
                        raise RuntimeError(f"probe_inv: CUDA error {code}")

                run()
                torch.cuda.synchronize()
                start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                start.record()
                for _ in range(10):
                    run()
                end.record()
                end.synchronize()
                ms[form] = start.elapsed_time(end) / 10
                outs[form] = y
            if not all(torch.equal(outs[FORMS[0]], outs[v]) for v in FORMS[1:]):
                raise AssertionError(f"{f.name} [{n}]: the inverse forms disagree")
            if f.unpack(outs[FORMS[0]][:4]) != [pow(v, f.p - 2, f.p) for v in vals[:4]]:
                raise AssertionError(f"{f.name} [{n}]: the inverse disagrees with Python integers")
            print(json.dumps(dict(modulus=f.name, threads=n, card=card, ms=ms)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
