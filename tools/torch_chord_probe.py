#!/usr/bin/env python3
"""Time the forms of phase B's affine and chord pass
(``zkecdsa_tpu_torch/csrc/chord.cu``) on one NVIDIA GPU, at the prover's
call: K = 10240 rows.

Run from the repository root, on a machine with a card and ``nvcc``:

    python3 tools/torch_chord_probe.py

It compiles a probe library (into ``build/chord_probe``) from
``csrc/chord.cu`` and the kernel it replaced, and times, with CUDA events
over 20 calls after a warm-up:

* ``pair``: the design before the fused kernel, a ``to_affine`` launch on
  T1 [K] and then the old ``chord`` kernel (its 15 inputs converted to
  Montgomery form and its 23 outputs back, 128-thread blocks, an inverse
  a row by ``fe_inv``) on rows that hold t1x and t1y;
* ``fused_<inverse>_<threads>``: the fused kernel (T1 projective in, one
  inverse a row for 1/Z and 1/i7) with the inverse by the addition chain
  for the P-256 prime (``chain``) or by ``fe_inv``'s 4-bit window
  (``window``), in blocks of 32, 64 and 128 threads;
* ``wrapper``: ``ops.curve_ops.chord`` as the prover calls it.

Every form must give the plain version's integers (the old pair its 25
outputs' counterparts).  Prints ptxas' lines for the probe's kernels and
one JSON line with each form's ms beside the card's name and power limit.
``chip_smoke.py`` times the old pair beside the shipped kernel through
:func:`old_chord_pair`.
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

K = 10240
THREADS = (32, 64, 128)

# The kernel the fused chord replaced (rows [K, 15, 9]: t1x t1y, then the
# 13 inputs of CHORD_IN -> [K, 23, 9]: i7..i13, ext_vals, ext_blinds).
PROBE = r"""
#include "chord.cu"

namespace {

constexpr int OLD_NIN = 15;
constexpr int OLD_NOUT = 23;

__global__ void old_chord_kernel(long long K, const uint32_t* __restrict__ in,
                                 uint32_t* __restrict__ out) {
    const long long k = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (k >= K) return;
    const ZkModulus& M = ZK_MODS[ZK_TOM_N];
    Fe v[OLD_NIN];
#pragma unroll
    for (int s = 0; s < OLD_NIN; ++s) {
        Fe t;
        fe_load(t, in + (k * OLD_NIN + s) * ZK_NL);
        fe_to_mont(v[s], t, M);
    }
    const uint32_t *t1x = v[0], *t1y = v[1], *pkx = v[2], *pky = v[3], *txv = v[4];
    const uint32_t *pky_r = v[5], *txr = v[6], *cb0 = v[7], *cb1 = v[8], *cb2 = v[9];
    const uint32_t* cb3 = v[10];
    const uint32_t* kx[4] = {v[11], v[12], v[13], v[14]};

    Fe r[OLD_NOUT];
    fe_sub(r[0], pkx, t1x, M);
    fe_inv(r[1], r[0], M);
    fe_sub(r[2], pky, t1y, M);
    fe_mont_mul(r[3], r[1], r[2], M);
    fe_mont_mul(r[4], r[3], r[3], M);
    fe_sub(r[5], t1x, txv, M);
    fe_mont_mul(r[6], r[3], r[5], M);
    const uint32_t* ys[4] = {r[1], r[2], r[3], r[5]};
    const uint32_t* xs[4] = {r[0], r[1], r[3], r[3]};
    Fe rb1, rb3;
    fe_sub(rb1, pky_r, cb1, M);
    fe_sub(rb3, cb0, txr, M);
    const uint32_t* rb[4] = {cb2, rb1, cb3, rb3};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
        fe_mont_mul(r[7 + j], xs[j], ys[j], M);
        fe_mont_mul(r[11 + j], kx[j], ys[j], M);
        fe_mont_mul(r[15 + j], xs[j], rb[j], M);
        fe_mont_mul(r[19 + j], kx[j], rb[j], M);
    }
#pragma unroll
    for (int s = 0; s < OLD_NOUT; ++s) {
        Fe t;
        fe_from_mont(t, r[s], M);
        fe_store(out + (k * OLD_NOUT + s) * ZK_NL, t);
    }
}

}  // namespace

extern "C" int probe_old_chord(long long K, const void* in, void* out, void* stream) {
    old_chord_kernel<<<(unsigned)((K + 127) / 128), 128, 0, (cudaStream_t)stream>>>(
        K, (const uint32_t*)in, (uint32_t*)out);
    return (int)cudaGetLastError();
}

extern "C" int probe_fused(long long K, int threads, int chain, const void* T1, const void* in,
                           void* out, void* stream) {
    const unsigned blocks = (unsigned)((K + threads - 1) / threads);
    cudaStream_t st = (cudaStream_t)stream;
    const uint32_t *t = (const uint32_t*)T1, *x = (const uint32_t*)in;
    if (chain) {
        chord_kernel<true><<<blocks, threads, 0, st>>>(K, t, x, (uint32_t*)out);
    } else {
        chord_kernel<false><<<blocks, threads, 0, st>>>(K, t, x, (uint32_t*)out);
    }
    return (int)cudaGetLastError();
}
"""


@functools.lru_cache(maxsize=None)
def build() -> ctypes.CDLL:
    """Compile and load the probe library (once a process); prints
    ptxas' lines for its kernels."""
    from zkecdsa_tpu_torch import _build as zb

    out = ROOT / "build" / "chord_probe"
    out.mkdir(parents=True, exist_ok=True)
    src = out / "chord_probe.cu"
    src.write_text(PROBE)
    lib = out / "libchordprobe.so"
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
    dll.probe_old_chord.argtypes = [L, P, P, P]
    dll.probe_fused.argtypes = [L, I, I, P, P, P, P]
    return dll


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


def _check(code: int, what: str) -> None:
    if code:
        raise RuntimeError(f"{what}: CUDA error {code}")


def old_chord_pair(T1, x, want, timer) -> tuple[dict, int]:
    """The design the fused chord replaced, on T1 [K, 3, 9] and rows
    [K, 13, 9]: a ``to_affine`` launch, then the old chord kernel on rows
    [K, 15, 9] that hold t1x and t1y.  Held exactly against ``want`` (the
    fused kernel's or the plain version's [K, 25, 9]) and timed with
    ``timer(fn, reps)``: ({"pair", "to_affine", "old_chord": ms}, 0)."""
    import torch

    from zkecdsa_tpu_torch.ops.curve_ops import p256_ops, to_affine

    dll = build()
    K = x.shape[0]
    stream = torch.cuda.current_stream().cuda_stream
    t1x, t1y, _ = to_affine(p256_ops, T1)
    x15 = torch.cat([torch.stack([t1x, t1y], dim=1), x], dim=1).contiguous()
    old = torch.empty((K, 23, 9), dtype=torch.int32, device=x.device)

    def old_chord():
        _check(dll.probe_old_chord(K, x15.data_ptr(), old.data_ptr(), stream), "probe_old_chord")

    old_chord()
    if not (torch.equal(torch.stack([t1x, t1y], dim=1), want[:, :2]) and torch.equal(old, want[:, 2:])):
        raise AssertionError("the old pair (to_affine + the old chord kernel) disagrees")
    ms = {"pair": timer(lambda: (to_affine(p256_ops, T1), old_chord()), 10),
          "to_affine": timer(lambda: to_affine(p256_ops, T1), 10), "old_chord": timer(old_chord, 10)}
    return ms, 0


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("torch_chord_probe: torch.cuda.is_available() is false", file=sys.stderr)
        return 2
    from zkecdsa_tpu_torch.curves.instances import p256
    from zkecdsa_tpu_torch.ops.curve_ops import chord, chord_plain, p256_ops
    from zkecdsa_tpu_torch.ops.field import TOM_N

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    dll = build()
    stream = torch.cuda.current_stream().cuda_stream
    rs = np.random.RandomState(11)
    q = TOM_N.p
    G = p256.generator()
    pool = [G.mul(p256.new_scalar(int.from_bytes(rs.bytes(32), "little") % p256.order)) for _ in range(64)]
    coords = []
    for i in range(K):
        lam = int.from_bytes(rs.bytes(40), "little") % (q - 1) + 1
        coords.extend(c * lam % q for c in p256_ops._host_coords(pool[i % 64]))
    T1 = TOM_N.pack(coords, "cuda").reshape(K, 3, -1)
    x = TOM_N.pack([int.from_bytes(rs.bytes(40), "little") % q for _ in range(K * 13)], "cuda").reshape(K, 13, -1)
    T1[1] = p256_ops.identity((), "cuda")  # Z = 0
    want = chord_plain(T1, x)
    x[2, 0] = want[2, 0]  # i7 = 0
    want = chord_plain(T1, x)

    # the pair it replaced: to_affine [K], then the old kernel on [K, 15]
    pair, _ = old_chord_pair(T1, x, want, lambda fn, reps: _ms(fn))
    ms = {f"pair_{k}" if k != "pair" else k: v for k, v in pair.items()}
    for chain, inv in ((1, "chain"), (0, "window")):
        for threads in THREADS:
            out = torch.empty_like(want)

            def run():
                _check(dll.probe_fused(K, threads, chain, T1.data_ptr(), x.data_ptr(), out.data_ptr(),
                                       stream), "probe_fused")

            ms[f"fused_{inv}_{threads}"] = _ms(run)
            if not torch.equal(out, want):
                raise AssertionError(f"fused {inv} at {threads} threads disagrees with the plain version")
    got = chord(T1, x)
    if not torch.equal(got, want):
        raise AssertionError("the wrapper disagrees with the plain version")
    ms["wrapper"] = _ms(lambda: chord(T1, x))
    print(json.dumps(dict(call=f"chord [{K}] (phase B: T1's affine pass and the chord pass)", card=card,
                          ms=ms)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
