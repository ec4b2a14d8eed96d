#!/usr/bin/env python3
"""Time ``msm_ladder``'s kernel (``zkecdsa_tpu_torch/csrc/ladder.cu``, a
team of four lanes a term) on one NVIDIA GPU, apart from the tree that
sums a row's terms, beside the kernel before its redesign
(``tools/ladder_old.cu``, a thread a term).

Run from the repository root, on a machine with a card and ``nvcc``:

    python3 tools/torch_ladder_probe.py [out.json]

It compiles a probe library (into ``build/ladder_probe``) from the shipped
``csrc/ladder.cu`` and ``tools/ladder_old.cu`` in one translation unit,
with a launcher of the shipped kernel in blocks of other sizes, prints
ptxas' registers, stack and spills of every ladder kernel, and calls the
C entries directly on B terms (no tree), each form held exactly against
the others and, at 4096 terms, against the plain version (one term a
row, so its tree is the term):

* at P-256 and Tom-256 [4, 1024] (4096 terms, ``chip_smoke.py``'s
  ``LADDER``): ``old`` (a thread a term, 64-thread blocks, a bit byte
  loaded every step), ``team`` (the shipped entry, 64-thread blocks),
  ``team_t32`` and ``team_t128`` (the same kernel in blocks of 32 and
  128 threads);
* at 16,384 and 65,536 terms, ``old`` against ``team``: where a thread a
  term, on a card it fills, catches up with the team.

Each form's ``device_ms`` is the kernel's own time a call
(``utils.profiling.kernel_device_ms``: the median launch in one
``torch.profiler`` trace of ``REPS`` calls a form), ``ms`` CUDA events over
the same calls; ``us_per_round`` divides ``device_ms`` by the chain (256
steps of 27 products on P-256 and 20 on Tom-256 for a thread, 9 and 6
team rounds for a team).  Prints the card's name and power limit, one JSON
line a shape and one with everything; ``out.json`` gets the same.
"""

from __future__ import annotations

import ctypes
import functools
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

PROBE = r"""
#include "ladder.cu"
#include "ladder_old.cu"

// the shipped kernel in blocks of 32 or 128 threads (its entry runs 64)
extern "C" int probe_team_ladder(int curve, long long B, int threads, const void* points,
                                 const void* bits, void* out, void* stream) {
    if (B == 0 || (threads != 32 && threads != 128)) return (int)cudaErrorInvalidValue;
    cudaStream_t st = (cudaStream_t)stream;
    const unsigned blocks = (unsigned)((B * ZK_TEAM + threads - 1) / threads);
    const uint32_t* p = (const uint32_t*)points;
    const uint8_t* b = (const uint8_t*)bits;
    const int bad = zk_dispatch_curve(curve, [&](auto c) {
        constexpr int CID = decltype(c)::value;
        if (threads == 32) {
            msm_ladder_kernel<CID, 32><<<blocks, 32, 0, st>>>(B, p, b, (uint32_t*)out);
        } else {
            msm_ladder_kernel<CID, 128><<<blocks, 128, 0, st>>>(B, p, b, (uint32_t*)out);
        }
    });
    return bad ? bad : (int)cudaGetLastError();
}
"""
OUT = ROOT / "build" / "ladder_probe"
REPS = 5
LADDER = 4096  # chip_smoke.py's LADDER, [4, 1024]
CROSSOVER = (4096, 16384, 65536)
TEAM_THREADS = (32, 128)  # blocks beside the shipped entry's 64
# chain a step: one lane's products, a team's rounds (csrc/curve.cuh)
CHAIN = {"p256": (27, 9), "tomEdwards256": (20, 6)}


def _ptxas(report: str) -> list[dict]:
    """ptxas' lines for each entry function: registers, stack, spills."""
    demangle = shutil.which("c++filt")
    out, cur = [], None
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = m.group(1)
            if demangle:
                name = subprocess.run([demangle, name], capture_output=True, text=True).stdout.strip() or name
            cur = dict(kernel=name)
            out.append(cur)
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and cur is not None and "stack" not in cur:
            cur.update(stack=int(m.group(1)), spill_stores=int(m.group(2)), spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m and cur is not None and "registers" not in cur:
            cur["registers"] = int(m.group(1))
    return out


@functools.lru_cache(maxsize=None)
def build():
    """Compile and load the probe library (once a process); returns
    (library, ptxas' lines for its kernels)."""
    from zkecdsa_tpu_torch import _build as zb

    OUT.mkdir(parents=True, exist_ok=True)
    src = OUT / "ladder_probe_tu.cu"
    src.write_text(PROBE)
    lib = OUT / "libladderprobe.so"
    res = subprocess.run(
        [zb._nvcc(), *zb._NVCC_FLAGS, "-shared", "-I", str(ROOT / "zkecdsa_tpu_torch" / "csrc"),
         "-I", str(ROOT / "tools"), str(src), "-o", str(lib)], capture_output=True, text=True)
    report = res.stdout + res.stderr
    if res.returncode != 0:
        raise RuntimeError("nvcc failed:\n" + report)
    ptx = [k for k in _ptxas(report) if "ladder" in k["kernel"]]
    for k in ptx:
        print(json.dumps(k), flush=True)
    dll = ctypes.CDLL(str(lib))
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    dll.probe_old_msm_ladder.argtypes = [I, L, P, P, P, P]
    dll.zk_msm_ladder.argtypes = [I, L, P, P, P, P]
    dll.probe_team_ladder.argtypes = [I, L, I, P, P, P, P]
    return dll, ptx


def _check(code: int, what: str) -> None:
    if code:
        raise RuntimeError(f"{what}: CUDA error {code}")


def _event_ms(fn, reps: int) -> float:
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


def _inputs(ops, g, B, rs, dev):
    """B terms: random projective representatives of 64 host points, the
    identity as term 2; random bits, term 0's all zero, term 1's all one."""
    import numpy as np
    import torch

    G = g.generator()
    host = [G.mul(g.new_scalar(int.from_bytes(rs.bytes(32), "little") % g.order)) for _ in range(64)]
    p = ops.f.p
    coords = []
    for i in range(B):
        lam = int.from_bytes(rs.bytes(40), "little") % (p - 1) + 1
        coords.extend(c * lam % p for c in ops._host_coords(host[i % 64]))
    P = ops.f.pack(coords, dev).reshape(B, ops.NCOORD, -1)
    P[2] = ops.identity((), dev)
    bits = rs.randint(0, 2, size=(B, 256)).astype(np.uint8)
    bits[0], bits[1] = 0, 1
    return P.contiguous(), torch.from_numpy(bits).to(dev).contiguous()


def probe_curve(dll, name, rs) -> list[dict]:
    import torch

    from zkecdsa_tpu_torch.curves.instances import p256, tomEdwards256
    from zkecdsa_tpu_torch.ops.curve_ops import p256_ops, tom_ops
    from zkecdsa_tpu_torch.utils.profiling import kernel_device_ms

    ops, g = {"p256": (p256_ops, p256), "tomEdwards256": (tom_ops, tomEdwards256)}[name]
    dev = "cuda"
    stream = torch.cuda.current_stream().cuda_stream
    lane_chain, team_chain = CHAIN[name]
    lines = []
    for B in CROSSOVER:
        P, bits = _inputs(ops, g, B, rs, dev)
        out = {}

        def form(key, entry, *args, B=B, P=P, bits=bits):
            o = out.setdefault(key, torch.empty_like(P))

            def fn():
                _check(getattr(dll, entry)(ops.curve_id, B, *args, P.data_ptr(), bits.data_ptr(), o.data_ptr(),
                                           stream), entry)
            return fn

        forms = {"old": (form("old", "probe_old_msm_ladder"), 64, lane_chain),
                 "team": (form("team", "zk_msm_ladder"), 64, team_chain)}
        if B == LADDER:
            forms.update({f"team_t{t}": (form(f"team_t{t}", "probe_team_ladder", t), t, team_chain)
                          for t in TEAM_THREADS})
        for fn, _, _ in forms.values():
            fn()
        torch.cuda.synchronize()
        ref = out["old"]
        if B == LADDER:  # the plain version, one term a row (its tree is the term)
            ref = ops.msm_ladder(P[:, None], bits[:, None])
        for key in forms:
            if not torch.equal(out[key], ref):
                raise AssertionError(f"{key} {name} [{B}] disagrees with the "
                                     + ("plain version" if B == LADDER else "old kernel"))
        names = {k: ["ladder_old_kernel"] if k == "old" else ["msm_ladder_kernel"] for k in forms}
        dms = kernel_device_ms([(fn, names[k], 1) for k, (fn, _, _) in forms.items()], REPS, str(OUT / "trace"))
        rec = dict(curve=name, terms=B, forms={})
        for (key, (fn, threads, chain)), d in zip(forms.items(), dms):
            rec["forms"][key] = dict(device_ms=d, ms=_event_ms(fn, REPS), us_per_round=d * 1e3 / (256 * chain),
                                     threads=threads)
        print(json.dumps(rec), flush=True)
        lines.append(rec)
    return lines


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("torch_ladder_probe: torch.cuda.is_available() is false", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    dll, ptx = build()
    rs = np.random.RandomState(16)
    lines = [rec for name in CHAIN for rec in probe_curve(dll, name, rs)]
    result = dict(card=card, ptxas=ptx, shapes=lines)
    print(json.dumps(result), flush=True)
    if len(sys.argv) > 1:
        Path(sys.argv[1]).parent.mkdir(parents=True, exist_ok=True)
        Path(sys.argv[1]).write_text(json.dumps(result, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
