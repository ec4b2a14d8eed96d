"""Polynomial interpolation mod m (L3b, reference src/proofGK/interpolate.ts).

Lagrange interpolation returned in coefficient form via the master
polynomial s(x) = prod (x - x_i) and its derivative; every output is
self-checked against the inputs (interpolate.ts:63-67 does the same,
throwing on mismatch).
"""

from __future__ import annotations

from ..bignum import big

__all__ = ["interpolate", "eval_poly"]


def eval_poly(coeff: list[int], x: int, m: int) -> int:
    """Horner evaluation (interpolate.ts:19-25)."""
    ret = 0
    for c in reversed(coeff):
        ret = (c + x * ret) % m
    return ret


def interpolate(xs: list[int], ys: list[int], m: int) -> list[int]:
    """Coefficients of the unique degree < n polynomial through
    (xs[i], ys[i]) mod m (interpolate.ts:27-70)."""
    if len(xs) != len(ys):
        raise ValueError("inconsistent args")
    n = len(xs)
    # s(x) = prod_i (x - xs[i]), degree n, s[n] = 1 (monic)
    s = [0] * (n + 1)
    s[n] = 1
    for i, xi in enumerate(xs):
        # multiply current s by (x - xi): shift + subtract
        for j in range(n - i - 1, n):
            s[j] = (s[j] - xi * s[j + 1]) % m
    coeff = [0] * n
    for xi, yi in zip(xs, ys):
        # phi = s'(xi) = prod_{j != i} (xi - xs[j])
        phi = 0
        for j in range(n, 0, -1):
            phi = (j * s[j] + xi * phi) % m
        ff = big.inv_mod(phi, m)
        # Accumulate y_i * l_i(x) where l_i = s(x)/((x - xi) * phi),
        # expanding s(x)/(x - xi) by synthetic division from the top.
        b = 1
        for j in range(n - 1, -1, -1):
            coeff[j] = (coeff[j] + b * ff * yi) % m
            b = (s[j] + xi * b) % m
    for xi, yi in zip(xs, ys):
        if yi % m != eval_poly(coeff, xi, m):
            raise ValueError("incorrect interpolation")
    return coeff
