#!/usr/bin/env python3
"""Time the forms of the mesh's field kernels (``zkecdsa_tpu_torch/csrc/
field.cu``: ``field_mul``, its pair and chain forms, ``field_sum``) on one
NVIDIA GPU, at every shape their callers give them.

Run from the repository root, on a machine with a card and ``nvcc``:

    python3 tools/torch_field_probe.py [out.json]

It compiles a probe library (into ``build/field_probe``) from the shipped
``csrc/field.cu``, ``tools/field_old.cu`` (the kernels before the
redesign) and ``tools/field_probe.cu`` (the forms the shipped kernel does
not hold) in one translation unit, and times each form with CUDA events
over 20 back-to-back calls after a warm-up (``ms``, the column
``chip_smoke.py`` keeps) and, from a ``torch.profiler`` trace of the same
loops (one trace a group of shapes), the kernels' own device time a call
(``device_ms``: the median launch times the launches a call).  Forms:
``old`` (the parent's kernel), ``new`` (the shipped kernel through its C
entry, under ``field_plan``'s geometry), ``wrapper`` (the Python wrapper
around it: its ``ms`` less ``new``'s is the wrapper's host time), and
for the P-256 prime ``cios`` (its Montgomery products in the shipped
geometry) and, for the pair form, ``summed_once`` (the two 512-bit
products added, then one reduction; the shipped form reduces each and
adds); for ``field_sum`` past 8 terms, ``lanes_<L>`` (a block of L lanes a
row, forced).  ``noop`` is an empty kernel launched the
same way (``zk_noop``): the launch floor.  Shapes:

* ``field_mul`` plain and pair form on the five moduli at [65536] (the
  row ``chip_smoke.py`` has always timed), plain form on the Tom-256
  order at [1536] (``sharded_gk_dvalues``) and [128]
  (``sharded_gk_recombine``);
* ``sharded_gk_total``'s chain, values [2048] times 12 factors a row: the
  old kernel and the new plain form as 12 launches (11 links, then the
  values), the chain form in one;
* ``field_sum`` on the Tom-256 order at [2, 1536], [2, 128], [2048, 1] and
  [2, 1].

Every form is held exactly against the plain version, edge values first.
Prints the card's name and power limit, ptxas' lines for the probe's
kernels, one JSON line a shape and one with everything; ``out.json`` gets
the same.
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

PROBE = r"""
#include "field.cu"
#include "field_old.cu"
#include "field_probe.cu"
"""
REPS = 20
MUL_ROWS = 65536
MUL_CALLS = ((1536, "sharded_gk_dvalues"), (128, "sharded_gk_recombine"))
CHAIN = (2048, 12)  # sharded_gk_total: [ring / 2 ring ranks, n]
SUM_CALLS = ((2, 1536, "sharded_gk_dvalues"), (2, 128, "sharded_gk_recombine"),
             (2048, 1, "sharded_gk_total, local"), (2, 1, "sharded_gk_total, gathered"))
SUM_LANES = (64, 128, 256, 512, 1024)  # field_sum's block geometry, forced past 8 terms
NOOP_GRIDS = ((1, 32), (48, 32), (512, 128))
TRACE_DIR = ROOT / "build" / "field_probe" / "trace"
MUL_K, CHAIN_K, SUM_K = ["field_mul_kernel"], ["field_chain_kernel"], ["field_sum_kernel",
                                                                        "field_sum_rows_kernel",
                                                                        "field_sum_block_kernel"]


@functools.lru_cache(maxsize=None)
def build() -> ctypes.CDLL:
    """Compile and load the probe library (once a process); prints
    ptxas' lines for its kernels."""
    from zkecdsa_tpu_torch import _build as zb

    out = ROOT / "build" / "field_probe"
    out.mkdir(parents=True, exist_ok=True)
    src = out / "field_probe_tu.cu"
    src.write_text(PROBE)
    lib = out / "libfieldprobe.so"
    res = subprocess.run(
        [zb._nvcc(), *zb._NVCC_FLAGS, "-shared", "-I", str(ROOT / "zkecdsa_tpu_torch" / "csrc"),
         "-I", str(ROOT / "tools"), str(src), "-o", str(lib)], capture_output=True, text=True)
    report = res.stdout + res.stderr
    for line in report.splitlines():
        if "field" in line or "noop" in line or "registers" in line or "spill" in line or "stack" in line:
            print(line)
    if res.returncode != 0:
        raise RuntimeError("nvcc failed:\n" + report)
    dll = ctypes.CDLL(str(lib))
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    mul_args = [L, L, P, L, L, P, L, L, P, L, L, P, L, L, P]
    dll.probe_old_field_mul.argtypes = [I] + mul_args + [P]
    dll.probe_old_field_sum.argtypes = [I, L, L, P, P, P]
    dll.probe_field_mul_form.argtypes = [I] + mul_args + [I, P]
    dll.probe_field_chain_cios.argtypes = [L, I, P, P, P, I, P]
    dll.zk_field_mul.argtypes = [I] + mul_args + [I, P]
    dll.zk_field_mul_chain.argtypes = [I, L, I, P, P, P, I, P]
    dll.zk_field_sum.argtypes = [I, L, L, P, P, I, I, P]
    dll.zk_noop.argtypes = [I, I, P]
    return dll


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


def _ints(f, rs, n: int) -> list[int]:
    """n values mod p, edge values first (0, 1, p-1, p-2)."""
    p = f.p
    edge = [0, 1, p - 1, p - 2][:n]
    return edge + [int.from_bytes(rs.bytes(40), "little") % p for _ in range(n - len(edge))]


def _stream():
    import torch

    return torch.cuda.current_stream().cuda_stream


def _threads(rows: int) -> int:
    import torch

    from zkecdsa_tpu_torch.ops.field import field_plan

    return field_plan(rows, torch.cuda.get_device_properties(0).multi_processor_count).threads


def _mul_call(entry, first, B, ops, out, threads):
    """A C entry of field_mul's signature on contiguous [B, 9] operands
    (2 or 4); ``first`` its leading argument (modulus id or form)."""
    args = []
    for i in range(4):
        args += [ops[i].data_ptr(), 0, 9] if i < len(ops) else [None, 0, 0]
    tail = [] if threads is None else [threads]
    return lambda: _check(entry(first, 1, B, *args, out.data_ptr(), *tail, _stream()), entry.__name__)


class Group:
    """Shapes timed together: each form exact against its shape's plain
    result, event-timed at once, device-timed in one trace at the end."""

    def __init__(self, log):
        self.log, self.lines, self.cases = log, [], []

    def shape(self, label, forms, want, out) -> None:
        """forms: name -> (fn, kernel names, launches a call); a fn that
        returns None writes ``out``."""
        import torch

        rec = {}
        for key, (fn, names, launches) in forms.items():
            if want is not None:
                out.zero_()
                got = fn()
                torch.cuda.synchronize()
                got = out if got is None else got
                if not torch.equal(got.reshape(want.shape), want):
                    raise AssertionError(f"{key} {label} disagrees with the plain version")
            rec[key] = dict(ms=_event_ms(fn, REPS))
            self.cases.append((rec[key], (fn, names, launches)))
        self.lines.append(dict(call=label, forms=rec))

    def finish(self) -> list:
        from zkecdsa_tpu_torch.utils.profiling import kernel_device_ms

        ms = kernel_device_ms([c for _, c in self.cases], REPS, str(TRACE_DIR))
        for (rec, _), t in zip(self.cases, ms):
            rec["device_ms"] = t
        for line in self.lines:
            self.log(json.dumps(line))
        return self.lines


def probe_mul(dll, rs, log) -> list:
    import torch

    from zkecdsa_tpu_torch.ops.field import P256_N, P256_P, TOM_N, TOM_P, WAR_P, field_mul, field_mul_plain

    g = Group(log)
    shapes = [(f, MUL_ROWS, "the row chip_smoke.py times") for f in (P256_P, P256_N, TOM_P, TOM_N, WAR_P)]
    shapes += [(TOM_N, B, use) for B, use in MUL_CALLS]
    for f, B, use in shapes:
        solinas = f in (P256_P, TOM_N)
        a, b = f.pack(_ints(f, rs, B), "cuda"), f.pack(_ints(f, rs, B)[::-1], "cuda")
        out = torch.empty_like(a)
        th = _threads(B)
        for ops in ([a, b], [a, b, b.flip(0).contiguous(), a.flip(0).contiguous()]) if B == MUL_ROWS else ([a, b],):
            want = field_mul_plain(f, *ops)
            forms = {
                "old": (_mul_call(dll.probe_old_field_mul, f.mod_id, B, ops, out, None), MUL_K, 1),
                "new": (_mul_call(dll.zk_field_mul, f.mod_id, B, ops, out, th), MUL_K, 1),
                "wrapper": (lambda ops=ops, f=f: field_mul(f, *ops), MUL_K, 1),
            }
            if solinas:
                forms["cios"] = (_mul_call(dll.probe_field_mul_form, 0, B, ops, out, th), MUL_K, 1)
                if len(ops) == 4:
                    forms["summed_once"] = (_mul_call(dll.probe_field_mul_form, 1, B, ops, out, th), MUL_K, 1)
            form = "pair" if len(ops) == 4 else "plain"
            g.shape(f"field_mul {form} {f.name} [{B}] ({use}; {th} threads a block)", forms, want, out)
    return g.finish()


def probe_chain(dll, rs, log) -> list:
    """sharded_gk_total's chain: values [R] times n factors a row."""
    import torch

    from zkecdsa_tpu_torch.ops.field import TOM_N, field_mul_chain, field_mul_chain_plain

    f = TOM_N
    R, n = CHAIN
    fac = f.pack(_ints(f, rs, R * n), "cuda").reshape(R, n, -1)
    vals = f.pack(_ints(f, rs, R), "cuda")
    want = field_mul_chain_plain(f, vals, fac)
    outs = [torch.empty_like(vals) for _ in range(n)]
    facs = [fac[:, j].contiguous() for j in range(n)]
    th = _threads(R)

    def links(entry, mod, threads):  # the parent's sharded_gk_total: n - 1 links, then the values
        calls = [_mul_call(entry, mod, R, [outs[j - 1] if j else facs[0], facs[j + 1] if j < n - 1 else vals],
                           outs[j], threads) for j in range(n)]

        def run():
            for c in calls:
                c()
            return outs[-1]
        return run

    out = outs[-1]
    forms = {
        "old": (links(dll.probe_old_field_mul, f.mod_id, None), MUL_K, n),
        "new_links": (links(dll.zk_field_mul, f.mod_id, th), MUL_K, n),
        "new": (lambda: _check(dll.zk_field_mul_chain(f.mod_id, R, n, vals.data_ptr(), fac.data_ptr(),
                                                      out.data_ptr(), th, _stream()), "zk_field_mul_chain"),
                CHAIN_K, 1),
        "wrapper": (lambda: field_mul_chain(f, vals, fac), CHAIN_K, 1),
        "cios": (lambda: _check(dll.probe_field_chain_cios(R, n, vals.data_ptr(), fac.data_ptr(), out.data_ptr(),
                                                           th, _stream()), "probe_field_chain_cios"),
                 CHAIN_K, 1),
    }
    g = Group(log)
    g.shape(f"sharded_gk_total chain {f.name} [{R}] x {n} ({th} threads a block)", forms, want, out)
    return g.finish()


def probe_sum(dll, rs, log) -> list:
    import torch

    from zkecdsa_tpu_torch.ops.field import TOM_N, field_plan, field_sum, field_sum_plain

    f, g = TOM_N, Group(log)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for D, R, use in SUM_CALLS:
        x = f.pack(_ints(f, rs, D * R), "cuda").reshape(D, R, -1)
        x[:, 0] = f.const(f.p - 1, "cuda")  # the first row sums p-1 D times
        out = torch.empty((R, 9), dtype=torch.int32, device="cuda")
        want = field_sum_plain(f, x)
        if f.unpack(want[:1]) != [(f.p - 1) * D % f.p]:
            raise AssertionError("the plain field_sum disagrees with Python integers")
        plan = field_plan(R, sms, D)
        forms = {
            "old": (lambda x=x, D=D, R=R, out=out: _check(dll.probe_old_field_sum(
                f.mod_id, D, R, x.data_ptr(), out.data_ptr(), _stream()), "probe_old_field_sum"), SUM_K, 1),
            "new": (lambda x=x, D=D, R=R, out=out, plan=plan: _check(dll.zk_field_sum(
                f.mod_id, D, R, x.data_ptr(), out.data_ptr(), plan.lanes, plan.threads, _stream()),
                "zk_field_sum"), SUM_K, 1),
            "wrapper": (lambda x=x: field_sum(f, x), SUM_K, 1),
        }
        if plan.lanes > 1:
            for lanes in SUM_LANES:
                forms[f"lanes_{lanes}"] = (lambda x=x, D=D, R=R, out=out, lanes=lanes: _check(dll.zk_field_sum(
                    f.mod_id, D, R, x.data_ptr(), out.data_ptr(), lanes, lanes, _stream()), "zk_field_sum"),
                    SUM_K, 1)
        g.shape(f"field_sum {f.name} [{D}, {R}] ({use}; {plan})", forms, want, out)
    return g.finish()


def probe_noop(dll, log) -> list:
    g = Group(log)
    forms = {f"noop <<<{b}, {t}>>>": ((lambda b=b, t=t: _check(dll.zk_noop(b, t, _stream()), "zk_noop")),
                                      ["noop_kernel"], 1) for b, t in NOOP_GRIDS}
    g.shape("launch floor", forms, None, None)
    return g.finish()


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("torch_field_probe: torch.cuda.is_available() is false", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    dll = build()

    def log(msg):
        print(msg, flush=True)

    rs = np.random.RandomState(15)
    lines = probe_noop(dll, log) + probe_mul(dll, rs, log) + probe_chain(dll, rs, log)
    lines += probe_sum(dll, rs, log) + probe_noop(dll, log)
    result = dict(card=card, shapes=lines)
    print(json.dumps(result), flush=True)
    if len(sys.argv) > 1:
        Path(sys.argv[1]).parent.mkdir(parents=True, exist_ok=True)
        Path(sys.argv[1]).write_text(json.dumps(result, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
