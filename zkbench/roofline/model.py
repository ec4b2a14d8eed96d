"""The frozen yardstick of the kernels' roofline: the least time one batch
of a path needs on one NVIDIA H100 SXM, from the work its device calls must
do, priced at frozen rates.

A path's calls are a table of rows (``prove.json``, ``verify.json`` beside
this file), each a kernel kind at a shape written in the batch's sizes.
Each kind's work is counted here as modular products and bytes, the least
work the algorithm needs on those inputs (each input byte read once, each
output byte written once), as ``chip_smoke.py``'s bounds count it at the
port's decomposition when this table was frozen.  A later kernel that does
the same work another way is judged against the same least time.

Frozen constants (NVIDIA's H100 SXM data sheet, at the full 700 W):

* ``HBM_BYTES_PER_S``: 3.35 TB/s of HBM3.
* ``IMAD_PER_S``: 16.75e12.  No tensor-core path exists for 32-bit modular
  products; they run on the INT32 pipes, 64 lanes an SM a clock, half the
  FP32 FMA lanes: half of 67 TFLOP/s over 2 flops an FMA.
* IMADs a product, one cost a modulus, whatever kernel computes it and
  however: a product mod the P-256 prime by Solinas reduction is the
  8x8-limb product's 64 wide products, its reduction additions only
  (``solinas_p256``, 128); a product mod any other modulus is a 9-limb
  Montgomery product, 81 limb products for a*b, 81 for q*p and 9 quotient
  digits, two IMADs each (``montgomery``, 342).  A row's ``curve`` names
  its modulus: ``p256`` the P-256 prime (the P-256 curve's coordinates,
  and the Tom-256 order of ``ring_fold``, ``chord`` and ``field_mul``,
  which is the same prime), ``tom256`` the Tom-256 prime.
* Products a point operation: a complete Weierstrass add 14, a doubling
  13; a twisted Edwards add 11, a doubling 9, a mixed add 9.
"""

from __future__ import annotations

import ast
import json
import operator
from pathlib import Path

HBM_BYTES_PER_S = 3.35e12
IMAD_PER_S = 16.75e12
IMAD_PER_PRODUCT = {"montgomery": 2 * (81 + 81 + 9), "solinas_p256": 2 * 64}
MODULUS = {"p256": "p256.p", "tom256": "tom.p"}  # a row's curve -> the modulus of its products
PRICING = {"p256.p": "solinas_p256", "tom.p": "montgomery"}
MM_WEIER_ADD, MM_WEIER_DBL = 14, 13
MM_EDW_ADD, MM_EDW_DBL, MM_EDW_MIXED = 11, 9, 9
LIMB_BYTES = 9 * 4  # a field element: nine 32-bit limbs
NCOORD = {"p256": 3, "tom256": 4}
PRIMES = {
    "p256.p": 0xFFFFFFFF00000001000000000000000000000000FFFFFFFFFFFFFFFFFFFFFFFF,
    "tom.p": 0x3FFFFFFFC000000040000000000000002AE382C7957CC4FF9713C3D82BC47D3AF,
}
# the fixed comb tables (Montgomery form, read once a call): P-256 h
# [32, 256, 3, 9], Tom-256 g and h [64, 256, 5, 9]
COMB_WEIER_BYTES = 32 * 256 * 3 * 9 * 4
COMB_MIXED_BYTES = 64 * 256 * 5 * 9 * 4
CHORD_IN, CHORD_OUT = 13, 25  # field values a phase-B row reads and writes

HERE = Path(__file__).resolve().parent


def fermat_products(p: int) -> int:
    """Products of the shortest fixed-window Fermat power a^(p-2), over
    windows of 1 to 6 bits."""
    e = p - 2
    best = None
    for w in range(1, 7):
        digits = [(e >> (w * i)) & ((1 << w) - 1) for i in range(-(-e.bit_length() // w))]
        cost = (1 << w) - 2 + w * (len(digits) - 1) + sum(1 for d in digits[:-1] if d)
        best = cost if best is None else min(best, cost)
    return best


def batch_inv_products(p: int, B: int) -> int:
    """B inversions by Montgomery's trick: 3(B-1) products and one Fermat
    inverse."""
    return 3 * max(B - 1, 0) + fermat_products(p) if B else 0


def _adds(curve: str) -> tuple[int, int]:
    return (MM_WEIER_ADD, MM_WEIER_DBL) if curve == "p256" else (MM_EDW_ADD, MM_EDW_DBL)


def _pt(curve: str) -> int:
    return NCOORD[curve] * LIMB_BYTES


def work(kind: str, curve: str = "p256", **s) -> tuple[int, int]:
    """(modular products, bytes) of one call of kernel ``kind`` at the
    sizes ``s``."""
    add, dbl = _adds(curve)
    pt = _pt(curve)
    if kind == "ec_add":  # B point pairs
        B = s["B"]
        return add * B, 3 * B * pt
    if kind == "tree_sum":  # n points summed in each of M columns
        n, M = s["n"], s["M"]
        return add * (n - 1) * M, (n * M + M) * pt
    if kind == "window_table":  # the multiples 0..15 of B points
        B = s["B"]
        return add * 14 * B, 17 * B * pt
    if kind == "to_affine":  # B points: one batch inversion, 2 products a point
        B = s["B"]
        p = PRIMES["p256.p" if curve == "p256" else "tom.p"]
        return batch_inv_products(p, B) + 2 * B, B * (NCOORD[curve] * LIMB_BYTES + 2 * LIMB_BYTES + 1)
    if kind == "shamir":  # R rows of u*P + v*Q; both tables' digits used or only the first
        R, tables = s["R"], s["tables"]
        return R * 64 * (4 * MM_WEIER_DBL + tables * MM_WEIER_ADD), \
            R * 16 * pt + 16 * pt + 2 * R * 64 + R * pt
    if kind == "comb4_bases":  # 64 position bases of B points, 252 doublings each
        B = s["B"]
        return B * 63 * 4 * MM_WEIER_DBL, B * pt + B * 64 * pt
    if kind == "comb4_entries":  # 16 entries of B*64 position bases
        B = s["B"]
        return B * 64 * (3 * MM_WEIER_DBL + 14 * MM_WEIER_ADD), B * 64 * 17 * pt
    if kind == "mul_comb4":  # B bases x E scalars from per-base tables
        B, E = s["B"], s["E"]
        return B * E * 64 * MM_WEIER_ADD, B * 64 * 16 * pt + B * E * 64 + B * E * pt
    if kind == "comb_weier":  # rows of the fixed P-256 table of h
        rows = s["rows"]
        return rows * 32 * MM_WEIER_ADD, COMB_WEIER_BYTES + rows * (32 + pt)
    if kind == "comb_mixed":  # B Tom-256 commitments g*v + h*r
        B = s["B"]
        return MM_EDW_MIXED * 64 * B, COMB_MIXED_BYTES + B * 64 + B * 4 * LIMB_BYTES
    if kind == "chord":  # K phase-B rows mod the Tom-256 order
        K = s["K"]
        return batch_inv_products(PRIMES["p256.p"], K) + 22 * K, K * (3 + CHORD_IN + CHORD_OUT) * LIMB_BYTES
    if kind == "ring_fold":  # M rows of n factor pairs over a ring of RING values
        M, n, RING = s["M"], s["n"], s["RING"]
        return 2 * M * (RING - 1), (RING + 2 * M * n + M) * LIMB_BYTES
    if kind == "straus_msm":  # R rows of T terms, ``terms`` live in ``rows`` rows
        R, T, terms, rows = s["R"], s["T"], s["terms"], s["rows"]
        return dbl * rows * 256 + add * terms * (14 + 64), R * T * (pt + 64) + R * pt
    if kind == "field_mul":  # B products, pair form reads 4 and writes 1
        B = s["B"]
        return B, 3 * B * LIMB_BYTES
    raise KeyError(f"no work rule for kernel kind {kind!r}")


def imad_per_product(curve: str) -> int:
    """IMADs a product mod the modulus a row's ``curve`` names."""
    return IMAD_PER_PRODUCT[PRICING[MODULUS[curve]]]


def least_seconds(kind: str, curve: str = "p256", **s) -> tuple[float, str]:
    """The least time of one call, and what bounds it ("operations" or
    "bytes")."""
    products, nbytes = work(kind, curve, **s)
    t_ops = products * imad_per_product(curve) / IMAD_PER_S
    t_bytes = nbytes / HBM_BYTES_PER_S
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


_OPS = {ast.Add: operator.add, ast.Sub: operator.sub, ast.Mult: operator.mul,
        ast.FloorDiv: operator.floordiv, ast.Pow: operator.pow}


def evaluate(expr, sizes: dict) -> int:
    """A size written in a table row: an integer, or arithmetic (+ - * //
    **, parentheses, ``max``/``min``) over the batch's named sizes."""
    if isinstance(expr, int):
        return expr

    def ev(node):
        if isinstance(node, ast.Expression):
            return ev(node.body)
        if isinstance(node, ast.Constant) and isinstance(node.value, int):
            return node.value
        if isinstance(node, ast.Name):
            return sizes[node.id]
        if isinstance(node, ast.BinOp) and type(node.op) in _OPS:
            return _OPS[type(node.op)](ev(node.left), ev(node.right))
        if isinstance(node, ast.Call) and isinstance(node.func, ast.Name) and node.func.id in ("max", "min"):
            return {"max": max, "min": min}[node.func.id](*(ev(a) for a in node.args))
        raise ValueError(f"not a size expression: {expr!r}")

    return int(ev(ast.parse(expr, mode="eval")))


def load_table(path_name: str) -> dict:
    """The frozen table of a path, ``<path_name>.json`` beside this file."""
    with open(HERE / f"{path_name}.json") as fh:
        return json.load(fh)


def table_rows(table: dict, sizes: dict) -> list[tuple[str, float, str]]:
    """(label, least seconds, bound by) of each call the table lists for a
    batch of these sizes; a row whose ``when`` size evaluates to 0 is
    left out."""
    sizes = dict(sizes)
    for name, expr in table.get("derived", {}).items():
        sizes[name] = evaluate(expr, sizes)
    out = []
    for row in table["calls"]:
        if "when" in row and not evaluate(row["when"], sizes):
            continue
        s = {k: evaluate(v, sizes) for k, v in row.get("sizes", {}).items()}
        t, by = least_seconds(row["kernel"], row.get("curve", "p256"), **s)
        out.append((row["label"], t, by))
    return out


def batch_least_seconds(path_name: str, sizes: dict) -> float:
    """The least time of one batch of the path at these sizes."""
    return sum(t for _, t, _ in table_rows(load_table(path_name), sizes))
