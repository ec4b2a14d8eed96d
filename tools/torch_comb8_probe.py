#!/usr/bin/env python3
"""Time the forms of the parameter set-up's comb-table kernels
(``zkecdsa_tpu_torch/csrc/comb8.cu``) on one NVIDIA GPU, at the set-up's
shapes: P-256 [1] (the table of h) and Tom-256 [2] (the tables of g and h).

Run from the repository root, on a machine with a card and ``nvcc``:

    python3 tools/torch_comb8_probe.py [out.json]

It compiles a probe library (into ``build/comb8_probe``) from the shipped
``csrc/comb8.cu``, ``tools/comb8_old.cu`` (the kernels before the
redesign) and ``tools/comb8_probe.cu`` (the probe's kernels) in one
translation unit, and times, with CUDA events over 10-20 calls after a
warm-up:

* ``bases_old``: the old ``comb8_bases`` (a team of four a base, the
  doubling in 4 rounds at P-256, 3 at Tom-256); ``bases``: the shipped
  kernel (16 lanes a base, 2 rounds a doubling);
* ``entries_old``: the old ``comb8_entries`` (every thread doubles, adds
  by one lane and runs a Fermat inverse); ``entries_<form>``: the shipped
  kernel's team rounds under each inverse form, ``fermat`` and
  ``vartime`` (one inverse a thread), ``tree_fermat`` (one batch
  inversion a window, the root by fe_inv; the probe's copy of the kernel,
  tools/comb8_probe.cu) and ``tree_vartime`` (the root by fe_inv_vartime:
  the shipped kernel, ``zk_comb8_entries``); ``entries``: the wrapper;
  ``phase_rounds``, ``phase_rounds_tree``: the kernel stopped after the
  index-set rounds, and the whole kernel but the inverse at the tree's
  root (timing only: no table);
* one product's latency on a chain of dependent products, in each form:
  ``cios`` (fe_mont_mul on one lane), ``team_round`` (team_mul4: the
  product and the exchange of four), ``limb_parallel`` (a product on 16
  lanes, tools/comb8_probe.cu); one inverse's: ``inv_fermat``,
  ``inv_vartime``; and one doubling's of ``comb8_bases``' chain
  (``wide_dbl``: 2 rounds of one product a lane on 16 lanes, and
  ``wide_round``, half of it), each the difference of two chain lengths
  over their difference, so the launch drops out.

Every form is held exactly against the plain versions (the bases bit for
bit, the tables in both forms), also on a P-256 call with an identity
base, and every chain against Python integers.  Prints the card's name
and power limit, ptxas' lines for the probe's kernels, and one JSON line
with every time; ``out.json`` gets the same.
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
#include "comb8.cu"
#include "comb8_old.cu"
#include "comb8_probe.cu"
"""
# tools/comb8_probe.cu InvForm: the forms (tree_vartime is the shipped
# kernel), then the phases (the rounds alone; all but the inverse at the
# tree's root)
FORMS = {"fermat": 0, "vartime": 1, "tree_fermat": 2}
PHASES = {"phase_rounds": 4, "phase_rounds_tree": 5}
# tools/comb8_probe.cu mul_chain_kernel forms: (name, form, short n, long n)
CHAINS = (("cios", 0, 64, 1024), ("team_round", 1, 64, 1024), ("limb_parallel", 2, 64, 1024),
          ("inv_fermat", 3, 4, 36), ("inv_vartime", 4, 4, 36))
R_MONT, R_LP = 1 << 288, 1 << 280


@functools.lru_cache(maxsize=None)
def build() -> ctypes.CDLL:
    """Compile and load the probe library (once a process); prints
    ptxas' lines for its kernels."""
    from zkecdsa_tpu_torch import _build as zb

    out = ROOT / "build" / "comb8_probe"
    out.mkdir(parents=True, exist_ok=True)
    src = out / "comb8_probe_tu.cu"
    src.write_text(PROBE)
    lib = out / "libcomb8probe.so"
    res = subprocess.run(
        [zb._nvcc(), *zb._NVCC_FLAGS, "-shared", "-I", str(ROOT / "zkecdsa_tpu_torch" / "csrc"),
         "-I", str(ROOT / "tools"), str(src), "-o", str(lib)], capture_output=True, text=True)
    report = res.stdout + res.stderr
    for line in report.splitlines():
        if "comb8" in line or "chain" in line or "registers" in line or "spill" in line:
            print(line)
    if res.returncode != 0:
        raise RuntimeError("nvcc failed:\n" + report)
    dll = ctypes.CDLL(str(lib))
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    dll.probe_old_comb8_bases.argtypes = [I, L, P, P, P]
    dll.probe_old_comb8_entries.argtypes = [I, L, P, P, P, P]
    dll.zk_comb8_bases.argtypes = [I, L, P, P, P]
    dll.probe_comb8_entries_form.argtypes = [I, I, L, P, P, P, P]
    dll.probe_mul_chain.argtypes = [I, I, I, P, P, P]
    dll.probe_dbl_chain.argtypes = [I, I, P, P, P]
    dll.zk_comb8_entries.argtypes = [I, L, P, P, P, P]
    return dll


def _ms(fn, reps: int) -> float:
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


def _check(code: int, what: str) -> None:
    if code:
        raise RuntimeError(f"{what}: CUDA error {code}")


def _points(g, n, rs):
    G = g.generator()
    return [G.mul(g.new_scalar(int.from_bytes(rs.bytes(32), "little") % g.order)) for _ in range(n)]


def probe_tables(dll, name, pts, timed: bool) -> dict:
    """Every form of both kernels on the bases ``pts`` of curve ``name``,
    exact against the plain versions; timed if ``timed``."""
    import torch

    from zkecdsa_tpu_torch.ops.curve_ops import (
        COMB_ENTRIES,
        COMB_WINDOWS,
        EdwardsOps,
        comb8_bases,
        comb8_entries,
        p256_ops,
        tom_ops,
    )
    from zkecdsa_tpu_torch.ops.field import NLIMBS

    ops = {"p256": p256_ops, "tomEdwards256": tom_ops}[name]
    dev, R = "cuda", len(pts)
    stream = torch.cuda.current_stream().cuda_stream
    P = ops.pack_points(pts, dev)
    want_b = ops.comb8_bases(P)
    bases = torch.empty_like(want_b)
    ms: dict[str, float] = {}

    def old_bases():
        _check(dll.probe_old_comb8_bases(ops.curve_id, R, P.data_ptr(), bases.data_ptr(), stream),
               "probe_old_comb8_bases")

    def new_bases():
        _check(dll.zk_comb8_bases(ops.curve_id, R, P.data_ptr(), bases.data_ptr(), stream), "zk_comb8_bases")

    for key, fn in (("bases_old", old_bases), ("bases", new_bases)):
        bases.zero_()
        fn()
        if not torch.equal(bases, want_b):
            raise AssertionError(f"{key} {name} [{R}] disagrees with the plain comb8_bases")
        if timed:
            ms[key] = _ms(fn, 10)
    if not torch.equal(comb8_bases(ops, P), want_b):
        raise AssertionError(f"comb8_bases {name} [{R}] disagrees with the plain version")

    want = ops.comb8_entries(want_b)
    nc = EdwardsOps.MIXED_NC if ops is tom_ops else ops.NCOORD
    canon = torch.empty((R, COMB_WINDOWS, COMB_ENTRIES, nc, NLIMBS), dtype=torch.int32, device=dev)
    mont = torch.empty_like(canon)

    def old_entries():
        _check(dll.probe_old_comb8_entries(ops.curve_id, R, want_b.data_ptr(), canon.data_ptr(),
                                           mont.data_ptr(), stream), "probe_old_comb8_entries")

    def form_entries(form):
        return lambda: _check(dll.probe_comb8_entries_form(
            ops.curve_id, form, R, want_b.data_ptr(), canon.data_ptr(), mont.data_ptr(), stream),
            "probe_comb8_entries_form")

    def shipped_entries():
        _check(dll.zk_comb8_entries(ops.curve_id, R, want_b.data_ptr(), canon.data_ptr(), mont.data_ptr(),
                                    stream), "zk_comb8_entries")

    runs = [("entries_old", old_entries)] + [(f"entries_{k}", form_entries(v)) for k, v in FORMS.items()]
    runs.append(("entries_tree_vartime", shipped_entries))
    for key, fn in runs:
        canon.zero_()
        mont.zero_()
        fn()
        if not (torch.equal(canon, want[0]) and torch.equal(mont, want[1])):
            raise AssertionError(f"{key} {name} [{R}, 32] disagrees with the plain comb8_entries")
        if timed:
            ms[key] = _ms(fn, 20)
    got = comb8_entries(ops, want_b)
    if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
        raise AssertionError(f"comb8_entries {name} [{R}, 32] disagrees with the plain version")
    if timed:
        ms["entries"] = _ms(lambda: comb8_entries(ops, want_b), 20)
        for key, form in PHASES.items():  # timing only: they write no table
            ms[key] = _ms(form_entries(form), 20)
    line = dict(call=f"{name} [{R}]", ms=ms)
    print(json.dumps(line), flush=True)
    return line


def probe_chains(dll, name, rs) -> dict:
    """One product's (and one inverse's, and one doubling's of comb8_bases)
    latency in each form, from two chain lengths; every chain's result
    against Python integers (the doublings against the plain
    comb8_bases)."""
    import torch

    from zkecdsa_tpu_torch.curves.instances import p256, tomEdwards256
    from zkecdsa_tpu_torch.ops.curve_ops import p256_ops, tom_ops

    ops = {"p256": p256_ops, "tomEdwards256": tom_ops}[name]
    f, p = ops.f, ops.f.p
    vals = [int.from_bytes(rs.bytes(40), "little") % p for _ in range(6)]  # x, y, team x_0..x_3
    xy = f.pack(vals, "cuda")
    out = torch.zeros((4, 9), dtype=torch.int32, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    x, y = vals[0], vals[1]
    lat: dict[str, float] = {}
    for key, form, n1, n2 in CHAINS:
        def run(n):
            _check(dll.probe_mul_chain(ops.curve_id, form, n, xy.data_ptr(), out.data_ptr(), stream),
                   "probe_mul_chain")

        for n in (n1, n2):
            run(n)
            torch.cuda.synchronize()
            if form == 0:
                ok = f.unpack(out[0]) == [x * pow(y * pow(R_MONT, -1, p), n, p) % p]
            elif form == 1:
                step = pow(y * pow(R_MONT, -1, p), n, p)
                ok = f.unpack(out) == [vals[2 + (q + n) % 4] * step % p for q in range(4)]
            elif form == 2:
                limbs = out.reshape(-1)[:10].cpu().tolist()
                got = sum((v & 0xFFFFFFFF) << (28 * j) for j, v in enumerate(limbs))
                ok = got % p == x * pow(y * pow(R_LP, -1, p), n, p) % p and got < 2 * p
            else:  # X -> X^-1 R^2 + R, Montgomery form of x -> 1/x + 1
                v = x
                for _ in range(n):
                    v = (pow(v, -1, p) * R_MONT * R_MONT + R_MONT) % p
                ok = f.unpack(out[0]) == [v]
            if not ok:
                raise AssertionError(f"{key} chain of {n} on {name} disagrees with Python integers")
        t1, t2 = _ms(lambda: run(n1), 5), _ms(lambda: run(n2), 5)
        lat[key] = (t2 - t1) / (n2 - n1) * 1e3  # us
    # comb8_bases' chain without its stores: 8 and 248 doublings of one
    # base, bit for bit the plain window bases 1 and 31
    g = {"p256": p256, "tomEdwards256": tomEdwards256}[name]
    P = ops.pack_points(_points(g, 1, rs), "cuda")
    want_b = ops.comb8_bases(P)[0]
    pt = torch.zeros_like(want_b[0])

    def dbl(n):
        _check(dll.probe_dbl_chain(ops.curve_id, n, P.data_ptr(), pt.data_ptr(), stream), "probe_dbl_chain")

    for n in (8, 248):
        pt.zero_()
        dbl(n)
        if not torch.equal(pt, want_b[n // 8]):
            raise AssertionError(f"wide_dbl chain of {n} on {name} disagrees with the plain comb8_bases")
    t1, t2 = _ms(lambda: dbl(8), 5), _ms(lambda: dbl(248), 5)
    lat["wide_dbl"] = (t2 - t1) / 240 * 1e3
    lat["wide_round"] = lat["wide_dbl"] / 2
    line = dict(call=f"{name} latency (us)", us=lat)
    print(json.dumps(line), flush=True)
    return line


def main() -> int:
    import numpy as np
    import torch

    from zkecdsa_tpu_torch.curves.instances import p256, tomEdwards256

    if not torch.cuda.is_available():
        print("torch_comb8_probe: torch.cuda.is_available() is false", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    dll = build()
    rs = np.random.RandomState(14)
    # exactness first: an identity base (every Z = 0 at P-256) among three
    probe_tables(dll, "p256", [_points(p256, 1, rs)[0], p256.identity(), _points(p256, 1, rs)[0]], False)
    probe_tables(dll, "tomEdwards256", [tomEdwards256.identity()] + _points(tomEdwards256, 2, rs), False)
    lines = [probe_tables(dll, "p256", _points(p256, 1, rs), True),
             probe_tables(dll, "tomEdwards256", _points(tomEdwards256, 2, rs), True),
             probe_chains(dll, "p256", rs), probe_chains(dll, "tomEdwards256", rs)]
    result = dict(card=card, shapes=lines)
    print(json.dumps(result), flush=True)
    if len(sys.argv) > 1:
        Path(sys.argv[1]).parent.mkdir(parents=True, exist_ok=True)
        Path(sys.argv[1]).write_text(json.dumps(result, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
