#!/usr/bin/env python3
"""Time designs of ``comb4_entries`` (the 16 entries of each (base,
position) row of the per-prove P-256 comb tables,
``zkecdsa_tpu_torch/csrc/comb4.cu``) on one NVIDIA GPU, at the prover's
call: 256 bases, [256, 64] rows, Montgomery form.

Run from the repository root, on a machine with a card and ``nvcc``:

    python3 tools/torch_comb4_entries_probe.py

It compiles a probe library (into ``build/comb4_entries_probe``) from
``csrc/curve.cuh`` and one kernel in four forms, each building a row as
the plain version does (m_k = dbl(entry k/2), entries k..2k-1 = entries
0..k-1 + m_k):

* ``thread``: one thread a row, its 16 points on the stack, per-thread
  formulas (the kernel before the team, 64 threads a block);
* ``team``: the shipped design: a team of four lanes a row runs every
  doubling and add (``team_weier_dbl``/``team_weier_add``), the row's
  entries in shared memory, 8 rows to a one-warp block;
* ``team_16``: ``team`` under ``__launch_bounds__(32, 16)``, which caps
  a thread at 128 registers so that 16 blocks fit an SM;
* ``level``: four lanes a row, each running whole per-thread adds of
  one level (the adds of a level are independent: 1, 2, 4 and 8 of
  them), every lane doubling m_k itself; entries in shared memory.

Every form must give the wrapper's integers.  Prints ptxas' lines for
the probe kernels and one JSON line with each form's ms and the
wrapper's (CUDA events, 10 calls after a warm-up) beside the card's name
and power limit.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

FORMS = ("thread", "team", "team_16", "level")

PROBE = r"""
#include "curve.cuh"

namespace {

constexpr int CID = ZK_CURVE_P256;
constexpr int PT = 3 * ZK_NL;
constexpr int ROWS = 8;  // rows (teams) per one-warp block

__global__ void thread_kernel(long long RJ, const uint32_t* __restrict__ bases,
                              uint32_t* __restrict__ tab) {
    const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (idx >= RJ) return;
    uint32_t* t = tab + idx * 16 * PT;
    Pt<CID> E[16], m;
    pt_identity<CID>(E[0]);
    pt_store_raw<CID>(t, E[0]);
    pt_load<CID>(E[1], bases + idx * PT);
    pt_store_raw<CID>(t + PT, E[1]);
    for (int k = 2; k < 16; k *= 2) {
        pt_dbl<CID>(m, E[k / 2]);
        for (int s = 0; s < k; ++s) {
            pt_add<CID>(E[k + s], E[s], m);
            pt_store_raw<CID>(t + (k + s) * PT, E[k + s]);
        }
    }
}

__device__ __forceinline__ void keep(uint32_t* e, uint32_t* g, const Pt<CID>& P, bool live) {
    const int q = team_lane();
    Fe c;
    team_coord<CID>(c, P);
    if (q < 3) fe_store(e + q * ZK_NL, c);
    if (live && q < 3) fe_store(g + q * ZK_NL, c);
    __syncwarp();
}

template <int MINB>
__global__ void __launch_bounds__(ROWS * ZK_TEAM, MINB) team_kernel(
    long long RJ, const uint32_t* __restrict__ bases, uint32_t* __restrict__ tab) {
    __shared__ uint32_t ent[ROWS * 16 * PT];
    const int team = threadIdx.x / ZK_TEAM;
    const long long row = (long long)blockIdx.x * ROWS + team;
    const bool live = row < RJ;
    const long long idx = live ? row : RJ - 1;
    uint32_t* t = tab + idx * 16 * PT;
    uint32_t* e = ent + team * 16 * PT;
    Pt<CID> a, m;
    pt_identity<CID>(a);
    keep(e, t, a, live);
    team_to_mont<CID>(a, bases + idx * PT);
    keep(e + PT, t + PT, a, live);
#pragma unroll 1
    for (int k = 2; k < 16; k *= 2) {
        pt_load_raw<CID>(a, e + (k / 2) * PT);
        team_dbl<CID>(m, a);
#pragma unroll 1
        for (int s = 0; s < k; ++s) {
            pt_load_raw<CID>(a, e + s * PT);
            team_add<CID>(a, a, m);
            keep(e + (k + s) * PT, t + (k + s) * PT, a, live);
        }
    }
}

__global__ void __launch_bounds__(ROWS * ZK_TEAM) level_kernel(
    long long RJ, const uint32_t* __restrict__ bases, uint32_t* __restrict__ tab) {
    __shared__ uint32_t ent[ROWS * 16 * PT];
    const int team = threadIdx.x / ZK_TEAM, q = team_lane();
    const long long row = (long long)blockIdx.x * ROWS + team;
    const bool live = row < RJ;
    const long long idx = live ? row : RJ - 1;
    uint32_t* t = tab + idx * 16 * PT;
    uint32_t* e = ent + team * 16 * PT;
    Pt<CID> a, m;
    if (q < 2) {
        if (q == 0) {
            pt_identity<CID>(a);
        } else {
            pt_load<CID>(a, bases + idx * PT);
        }
        pt_store_raw<CID>(e + q * PT, a);
        if (live) pt_store_raw<CID>(t + q * PT, a);
    }
    __syncwarp();
#pragma unroll 1
    for (int k = 2; k < 16; k *= 2) {
        pt_load_raw<CID>(a, e + (k / 2) * PT);
        pt_dbl<CID>(m, a);
#pragma unroll 1
        for (int s = q; s < k; s += ZK_TEAM) {
            pt_load_raw<CID>(a, e + s * PT);
            pt_add<CID>(a, a, m);
            pt_store_raw<CID>(e + (k + s) * PT, a);
            if (live) pt_store_raw<CID>(t + (k + s) * PT, a);
        }
        __syncwarp();
    }
}

}  // namespace

extern "C" int probe_entries(int form, long long R, const void* bases, void* tab, void* stream) {
    cudaStream_t st = (cudaStream_t)stream;
    const long long RJ = R * 64;
    const uint32_t* b = (const uint32_t*)bases;
    uint32_t* t = (uint32_t*)tab;
    const unsigned teams = (unsigned)((RJ + ROWS - 1) / ROWS);
    if (form == 0) thread_kernel<<<(unsigned)((RJ + 63) / 64), 64, 0, st>>>(RJ, b, t);
    if (form == 1) team_kernel<1><<<teams, ROWS * ZK_TEAM, 0, st>>>(RJ, b, t);
    if (form == 2) team_kernel<16><<<teams, ROWS * ZK_TEAM, 0, st>>>(RJ, b, t);
    if (form == 3) level_kernel<<<teams, ROWS * ZK_TEAM, 0, st>>>(RJ, b, t);
    return (int)cudaGetLastError();
}
"""


def _build() -> ctypes.CDLL:
    from zkecdsa_tpu_torch import _build as zb

    out = ROOT / "build" / "comb4_entries_probe"
    out.mkdir(parents=True, exist_ok=True)
    src = out / "comb4_entries_probe.cu"
    src.write_text(PROBE)
    lib = out / "libcomb4entriesprobe.so"
    res = subprocess.run(
        [zb._nvcc(), *zb._NVCC_FLAGS, "-shared", "-I", str(ROOT / "zkecdsa_tpu_torch" / "csrc"),
         str(src), "-o", str(lib)], capture_output=True, text=True)
    report = res.stdout + res.stderr
    for line in report.splitlines():
        if "_kernel" in line or "registers" in line or "spill" in line:
            print(line)
    if res.returncode != 0:
        raise RuntimeError("nvcc failed:\n" + report)
    dll = ctypes.CDLL(str(lib))
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    dll.probe_entries.argtypes = [I, L, P, P, P]
    dll.probe_entries.restype = ctypes.c_int
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
        print("torch_comb4_entries_probe: torch.cuda.is_available() is false", file=sys.stderr)
        return 2
    from zkecdsa_tpu_torch.curves.instances import p256
    from zkecdsa_tpu_torch.ops.curve_ops import comb4_bases, comb4_entries, p256_ops

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    dll = _build()
    stream = torch.cuda.current_stream().cuda_stream
    rs = np.random.RandomState(10)
    G = p256.generator()
    R = 256
    pts = [G.mul(p256.new_scalar(int.from_bytes(rs.bytes(32), "little") % p256.order)) for _ in range(R)]
    bases = comb4_bases(p256_ops.pack_points(pts, "cuda"))
    want = comb4_entries(bases)  # Montgomery form, the prover's call
    ms = {"wrapper": _ms(lambda: comb4_entries(bases))}
    for k, form in enumerate(FORMS):
        out = torch.empty_like(want)

        def run():
            code = dll.probe_entries(k, R, bases.data_ptr(), out.data_ptr(), stream)
            if code:
                raise RuntimeError(f"probe_entries: CUDA error {code}")

        ms[form] = _ms(run)
        if not torch.equal(out, want):
            raise AssertionError(f"form {form} disagrees with the wrapper")
    print(json.dumps(dict(call=f"comb4_entries [{R}, 64] (Montgomery form)", card=card, ms=ms)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
