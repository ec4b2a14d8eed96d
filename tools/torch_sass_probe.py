#!/usr/bin/env python3
"""What one field step and one MSM kernel cost in machine code, for the
port's CUDA kernels (``zkecdsa_tpu_torch/csrc``) on sm_90a.

Run from the repository root, on a machine with ``nvcc`` and ``cuobjdump``:

    python3 tools/torch_sass_probe.py [out_dir]

It builds the kernel library where it is missing or stale
(``_build.load``), then

* copies ptxas' lines (registers, stack, spills) of the ``shamir``,
  ``straus``, ``comb_mixed`` and ``comb4_bases`` kernels from
  ``nvcc.log``;
* dumps their SASS and counts local-memory instructions (``LDL``/``STL``)
  and the instructions by opcode;
* compiles probe kernels that run exactly one ``fe_mont_mul``, one
  ``fe_add`` and one ``fe_sub`` on P-256's base field between a load and
  a store, and counts their SASS instructions by opcode (loads, stores,
  branches and ``EXIT`` excluded): the instructions one inlined step puts
  on a chain; ``probe_mont_mul_ptx`` is the same product with its rows as
  PTX ``mad.lo.cc``/``madc.hi.cc`` carry chains, for comparison.

The full SASS of every instantiation of these kernels goes to ``out_dir``
(default ``build/sass``), one file a mangled name; the counts are printed.
"""

from __future__ import annotations

import collections
import re
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from zkecdsa_tpu_torch import _build  # noqa: E402

KERNELS = ("shamir_kernel", "straus_kernel", "comb_mixed_kernel", "comb4_bases_kernel")
_SKIP = {"LDG", "STG", "LDC", "EXIT", "BRA", "NOP", "S2R", "ULDC", "MOV", "RET"}

PROBE = r"""
#include "field.cuh"
extern "C" __global__ void probe_mont_mul(const uint32_t* a, const uint32_t* b, uint32_t* r) {
    Fe x, y, z; fe_load(x, a); fe_load(y, b);
    fe_mont_mul(z, x, y, ZK_MODS[ZK_P256_P]); fe_store(r, z);
}
// the same product with each row as PTX carry chains (mad.lo.cc / madc.hi.cc)
__device__ __forceinline__ void mad_lo(uint32_t* t, const uint32_t* x, uint32_t y) {
    asm("mad.lo.cc.u32 %0, %11, %20, %0;\n\t" "madc.lo.cc.u32 %1, %12, %20, %1;\n\t"
        "madc.lo.cc.u32 %2, %13, %20, %2;\n\t" "madc.lo.cc.u32 %3, %14, %20, %3;\n\t"
        "madc.lo.cc.u32 %4, %15, %20, %4;\n\t" "madc.lo.cc.u32 %5, %16, %20, %5;\n\t"
        "madc.lo.cc.u32 %6, %17, %20, %6;\n\t" "madc.lo.cc.u32 %7, %18, %20, %7;\n\t"
        "madc.lo.cc.u32 %8, %19, %20, %8;\n\t" "addc.cc.u32 %9, %9, 0;\n\t" "addc.u32 %10, %10, 0;"
        : "+r"(t[0]), "+r"(t[1]), "+r"(t[2]), "+r"(t[3]), "+r"(t[4]), "+r"(t[5]), "+r"(t[6]),
          "+r"(t[7]), "+r"(t[8]), "+r"(t[9]), "+r"(t[10]) : ZK_L9(x), "r"(y));
}
__device__ __forceinline__ void mad_hi(uint32_t* t, const uint32_t* x, uint32_t y) {
    asm("mad.hi.cc.u32 %0, %10, %19, %0;\n\t" "madc.hi.cc.u32 %1, %11, %19, %1;\n\t"
        "madc.hi.cc.u32 %2, %12, %19, %2;\n\t" "madc.hi.cc.u32 %3, %13, %19, %3;\n\t"
        "madc.hi.cc.u32 %4, %14, %19, %4;\n\t" "madc.hi.cc.u32 %5, %15, %19, %5;\n\t"
        "madc.hi.cc.u32 %6, %16, %19, %6;\n\t" "madc.hi.cc.u32 %7, %17, %19, %7;\n\t"
        "madc.hi.cc.u32 %8, %18, %19, %8;\n\t" "addc.u32 %9, %9, 0;"
        : "+r"(t[1]), "+r"(t[2]), "+r"(t[3]), "+r"(t[4]), "+r"(t[5]), "+r"(t[6]), "+r"(t[7]),
          "+r"(t[8]), "+r"(t[9]), "+r"(t[10]) : ZK_L9(x), "r"(y));
}
extern "C" __global__ void probe_mont_mul_ptx(const uint32_t* a, const uint32_t* b, uint32_t* r) {
    const ZkModulus& M = ZK_MODS[ZK_P256_P];
    Fe x, y, z; fe_load(x, a); fe_load(y, b);
    uint32_t t[ZK_NL + 2] = {0};
#pragma unroll
    for (int i = 0; i < ZK_NL; ++i) {
        mad_lo(t, x, y[i]); mad_hi(t, x, y[i]);
        const uint32_t q = t[0] * M.pinv;
        mad_lo(t, M.p, q); mad_hi(t, M.p, q);
#pragma unroll
        for (int j = 0; j < ZK_NL + 1; ++j) t[j] = t[j + 1];
        t[ZK_NL + 1] = 0u;
    }
    fe_reduce_once(z, t, t[ZK_NL], M); fe_store(r, z);
}
extern "C" __global__ void probe_add(const uint32_t* a, const uint32_t* b, uint32_t* r) {
    Fe x, y, z; fe_load(x, a); fe_load(y, b);
    fe_add(z, x, y, ZK_MODS[ZK_P256_P]); fe_store(r, z);
}
extern "C" __global__ void probe_sub(const uint32_t* a, const uint32_t* b, uint32_t* r) {
    Fe x, y, z; fe_load(x, a); fe_load(y, b);
    fe_sub(z, x, y, ZK_MODS[ZK_P256_P]); fe_store(r, z);
}
"""


def _functions(sass: str) -> dict[str, list[str]]:
    """cuobjdump -sass output -> {function name: [instruction text]}."""
    out: dict[str, list[str]] = {}
    cur = None
    for line in sass.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            cur = m.group(1)
            out[cur] = []
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(.*?);", line)
        if cur and m:
            out[cur].append(m.group(1).strip())
    return out


def _opcode(ins: str) -> str:
    ins = re.sub(r"^@!?U?P\w+\s+", "", ins)  # predicate guard
    return ins.split()[0].split(".")[0]


def _histogram(ins: list[str], skip=frozenset()) -> collections.Counter:
    return collections.Counter(op for op in map(_opcode, ins) if op not in skip)


def main() -> int:
    out_dir = Path(sys.argv[1] if len(sys.argv) > 1 else ROOT / "build" / "sass")
    out_dir.mkdir(parents=True, exist_ok=True)
    _build.load()
    log = _build.LOG_PATH.read_text()
    print("== ptxas (nvcc.log) for " + ", ".join(KERNELS))
    lines = log.splitlines()
    for i, line in enumerate(lines):
        if "Compiling entry function" in line and any(k in line for k in KERNELS):
            print("\n".join(lines[i : i + 4]))
    sass = subprocess.run(["cuobjdump", "-sass", str(_build.LIB_PATH)], capture_output=True,
                          text=True, check=True).stdout
    for name, ins in _functions(sass).items():
        if not any(k in name for k in KERNELS):
            continue
        # the full mangled name: the curve instantiations of one template
        # differ only in their template arguments
        (out_dir / f"sass_{name}.txt").write_text("\n".join(ins))
        h = _histogram(ins)
        local = h.get("LDL", 0) + h.get("STL", 0)
        print(f"== {name}: {len(ins)} instructions, LDL {h.get('LDL', 0)}, STL {h.get('STL', 0)}"
              f" ({'local memory' if local else 'no local memory'}); top opcodes {h.most_common(12)}")
    with tempfile.TemporaryDirectory() as tmp:
        src = Path(tmp) / "probe.cu"
        src.write_text(PROBE)
        cubin = Path(tmp) / "probe.cubin"
        subprocess.run([_build._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
                        "-O3", "-cubin", "-I", str(_build._SRC), str(src), "-o", str(cubin)],
                       check=True)
        psass = subprocess.run(["cuobjdump", "-sass", str(cubin)], capture_output=True, text=True,
                               check=True).stdout
    for name, ins in sorted(_functions(psass).items()):
        h = _histogram(ins, _SKIP)
        print(f"== {name}: {sum(h.values())} arithmetic instructions {dict(h.most_common())}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
