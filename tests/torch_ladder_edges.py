"""Edge rows of ``msm_ladder`` (a double-and-add ladder a term, then a
tree), shared by the CPU test against the JAX package
(tests/test_torch_msm.py) and the kernel's ``cuda`` tests
(tests/test_torch_kernels.py).  No JAX here."""

import numpy as np

ALL_ONES = (1 << 256) - 1


def ladder_edge_rows(g, rs: np.random.RandomState, R: int, T: int):
    """R rows of T terms (R >= 3) for ``msm_ladder``: row 0 with every bit
    zero (its sum is the identity), row 1 with every bit one (a scalar of
    2^256 - 1: every step adds), row 2 holding the identity point as its
    first term, with every bit one, and as its last, then random rows with
    the scalars 0, 1 and order - 1 at their head.  Returns (host points
    [R * T], scalars [R][T], MSB-first bits [R, T, 256] uint8)."""
    if R < 3:
        raise ValueError("the edge rows take at least three rows")
    G = g.generator()
    pts = [G.mul(g.new_scalar(int.from_bytes(rs.bytes(32), "big") % g.order)) for _ in range(R * T)]
    scs = [[int.from_bytes(rs.bytes(32), "big") % g.order for _ in range(T)] for _ in range(R)]
    scs[0] = [0] * T
    scs[1] = [ALL_ONES] * T
    scs[2][0] = ALL_ONES
    pts[2 * T] = pts[3 * T - 1] = g.identity()
    for row in scs[3:]:
        row[:3] = [0, 1, g.order - 1][:T]
    flat = [s for row in scs for s in row]
    by = np.frombuffer(b"".join(s.to_bytes(32, "big") for s in flat), dtype=np.uint8)
    bits = np.unpackbits(by.reshape(R * T, 32), axis=1).reshape(R, T, 256)
    return pts, scs, bits
