"""Pippenger bucket MSM per row: the port of
``zkecdsa_tpu/ops/msm_bucket.py``.

out[i] = sum_t s[i, t] * P[i, t] for points [N, T, C, 9] and host-int
scalars.  Each scalar is cut into D = ceil(256 / w) base-2^w digits, MSB
window first (:func:`window_digits`).  Per (row, window d, bucket b) the
points whose digit is b are summed into S[i, d, b]; per window the buckets
fold into W_d = sum_b b * S_b; the windows fold by Horner, w doublings and
one add each.  Unlike the Straus kernel there is no [T, 16] window table:
the scratch is the [N, D, B] bucket sums.

Two kernels (``csrc/bucket.cu``), counted apart, their geometry from
:func:`bucket_plan`:

* :func:`bucket_sums` replaces the chunk gather and the two trees of the
  reference (``msm_bucket.py:138-143``): one block per (row, window)
  lists the terms by bucket in shared memory (a stable counting sort,
  O(T)), and a team of four lanes a bucket (a lane past 64 buckets) adds
  its terms, from the first; where the digits leave units idle (the top
  window holds 256 - (D-1)*w real bits) each bucket gets several units
  and a tree merges them.  It needs no host layout, so it has no static
  chunk budget and nothing to overflow.
* :func:`bucket_fold` replaces the masked bit fold, the Horner over bits
  and the window fold (``msm_bucket.py:144-171``): a team of four lanes
  a segment of a window's buckets (running sums, a multiple, a tree over
  the segments), then the row's last block folds the windows by Horner
  in groups.

Neither kernel converts to Montgomery form: a canonical coordinate read
as a Montgomery residue is the point scaled by R^-1, the same projective
point, so the kernels' coordinates are those of the same group elements.

The plain versions (:func:`bucket_sums_plain`, :func:`bucket_fold_plain`)
follow the reference's schedule, operation for operation, on its host
chunk layout (:func:`bucket_layout`): chunk trees, bucket trees, the
masked [w, B] bit fold with its Horner, then the window fold.  The kernels
add in another order, so their projective coordinates differ from the
plain versions'; the group elements are the same.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import _build
from .curve_ops import CurveOps, _check_points, _index, _resident_warps, _stream, scalar_bits
from .field import NLIMBS

__all__ = [
    "pick_window",
    "n_windows",
    "window_digits",
    "bucket_layout",
    "bucket_bytes",
    "BucketPlan",
    "bucket_plan",
    "bucket_teams",
    "fold_rounds",
    "bucket_sums",
    "bucket_sums_plain",
    "bucket_fold",
    "bucket_fold_plain",
    "msm_bucket_rows",
]


def pick_window(T: int) -> int:
    """Window width by term count (the reference's operation-count model:
    larger windows amortise fewer, wider folds against more buckets)."""
    if T <= 2048:
        return 5
    if T <= 8192:
        return 6
    return 7


def n_windows(window: int) -> int:
    """Digits of a 256-bit scalar in base 2^window."""
    return -(-256 // window)


def window_digits(scalars_rows, T: int, window: int) -> np.ndarray:
    """Base-2^w digits of each row's scalars, MSB window first: [N, D, T]
    uint8.  Rows shorter than T are padded with zero scalars.  As the
    reference computes them: the 256 bits are padded at the top to D*w
    bits, so the top window holds 256 - (D-1)*w real bits."""
    _check_window(window)
    D = n_windows(window)
    N = len(scalars_rows)
    flat: list[int] = []
    for row in scalars_rows:
        if len(row) > T:
            raise ValueError(f"a row has {len(row)} scalars, more than T={T}")
        flat.extend(int(s) for s in row)
        flat.extend([0] * (T - len(row)))
    bits = scalar_bits(flat, 256)  # [N*T, 256] MSB first
    bits = np.pad(bits, ((0, 0), (D * window - 256, 0))).reshape(N, T, D, window)
    digs = np.zeros((N, T, D), np.uint8)
    for j in range(window):  # MSB bit of the window first
        digs = (digs << 1) | bits[..., j]
    return np.ascontiguousarray(digs.transpose(0, 2, 1))


def _check_window(window: int) -> None:
    """Digits travel as uint8: at most 8 bits a window."""
    if not 1 <= window <= 8:
        raise ValueError(f"window must be 1..8 bits, got {window}")


def _layout(digs: np.ndarray, T: int, window: int):
    """The reference's chunk layout from digits [N, D, T]: per (row,
    window), each bucket's terms (in term order) in chunks of M; chunk_idx
    [N, D, R, M] holds term indices (T = the identity pad), bucket_chunks
    [N, D, B, K] chunk rows (R = the identity pad).  Bucket 0 is dropped.
    The static row budget R is checked before a chunk is written (the
    reference writes first and checks after, ``msm_bucket.py:112/117``)."""
    B = 1 << window
    N, D = digs.shape[0], digs.shape[1]
    lam = max(1, T // B)
    M = max(4, min(T, 2 * lam))  # chunk capacity
    R = B + -(-T // M)  # static row budget: <= 1 partial chunk per bucket
    counts = np.zeros((N, D, B), np.int64)
    for i in range(N):
        for d in range(D):
            counts[i, d] = np.bincount(digs[i, d], minlength=B)
    counts[:, :, 0] = 0  # bucket 0 contributes nothing
    kmax = int(np.max(-(-counts // M))) if counts.size else 1
    K = 1 << max(2, (max(kmax, 1) - 1).bit_length())
    chunk_idx = np.full((N, D, R, M), T, np.int32)
    bucket_chunks = np.full((N, D, B, K), R, np.int32)
    for i in range(N):
        for d in range(D):
            order = np.argsort(digs[i, d], kind="stable")
            ends = np.cumsum(np.bincount(digs[i, d], minlength=B))
            r = 0
            for b in range(1, B):
                t, end = int(ends[b - 1]), int(ends[b])
                ks = 0
                while t < end:
                    if r >= R:  # pragma: no cover - the R bound is provable
                        raise OverflowError("chunk rows exceeded the static budget")
                    take = min(M, end - t)
                    chunk_idx[i, d, r, :take] = order[t : t + take]
                    bucket_chunks[i, d, b, ks] = r
                    r += 1
                    ks += 1
                    t += take
    return chunk_idx, bucket_chunks, (B, D, R, M, K, window)


def bucket_layout(scalars_rows, T: int, window: int):
    """The reference's host layout (``msm_bucket.py:56 bucket_layout``):
    (chunk_idx [N, D, R, M], bucket_chunks [N, D, B, K], (B, D, R, M, K,
    window)) for rows of T scalars.  Only the plain version uses it."""
    return _layout(window_digits(scalars_rows, T, window), T, window)


def bucket_bytes(ops: CurveOps, R: int, window: int) -> int:
    """Scratch bytes of the bucket sums of R rows."""
    return R * n_windows(window) * (1 << window) * ops.NCOORD * NLIMBS * 4


def bucket_sums_plain(ops: CurveOps, points: torch.Tensor, digits: torch.Tensor, window: int) -> torch.Tensor:
    """S[i, d, b] = sum of the points of row i whose window-d digit is b:
    points [N, T, C, 9], digits [N, D, T] -> [N, D, B, C, 9], in the
    reference's schedule (a tree over each chunk of M terms, then a tree
    over each bucket's K chunk sums; bucket 0 sums K identities)."""
    N, T = points.shape[0], points.shape[1]
    dev = points.device
    chunk_idx, bucket_chunks, (B, D, R, M, K, _) = _layout(digits.cpu().numpy(), T, window)
    pad = torch.cat([ops._work(points), ops._work(ops.identity((N, 1), dev))], dim=1)
    rows = torch.arange(N, device=dev)[:, None, None, None]
    chunks = pad[rows, torch.from_numpy(chunk_idx).to(dev).long()]  # [N, D, R, M, C, W]
    csums = ops._wsum(chunks, axis=3)  # [N, D, R, C, W]
    csums = torch.cat([csums, ops._work(ops.identity((N, D, 1), dev))], dim=2)
    wins = torch.arange(D, device=dev)[None, :, None, None]
    bsums = csums[rows, wins, torch.from_numpy(bucket_chunks).to(dev).long()]  # [N, D, B, K, C, W]
    return ops._canon(ops._wsum(bsums, axis=3))


def bucket_fold_plain(ops: CurveOps, S: torch.Tensor, window: int) -> torch.Tensor:
    """Bucket sums [N, D, B, C, 9] -> [N, C, 9], in the reference's
    schedule: per window sum_b b * S_b = sum_k 2^k U_k with U_k the tree sum
    of the buckets whose bit k is set (one masked [w, B] stack), by a w-step
    Horner (a doubling and an add); then the windows MSB first, w doublings
    and one add each."""
    N, D, B = S.shape[0], S.shape[1], S.shape[2]
    dev = S.device
    b = torch.arange(B, device=dev)
    k = torch.arange(window, device=dev)
    mask = ((b[None, :] >> (window - 1 - k[:, None])) & 1) > 0  # [w, B], MSB bit first
    Sw = ops._work(S)[:, :, None]  # [N, D, 1, B, C, W]
    ident = ops._work(ops.identity((N, D, window, B), dev))
    U = ops._wsum(torch.where(mask[:, :, None, None], Sw, ident), axis=3)  # [N, D, w, C, W]
    wsum = ops._work(ops.identity((N, D), dev))
    for j in range(window):
        wsum = ops._wadd(ops._wdbl(wsum), U[:, :, j])
    acc = ops._work(ops.identity((N,), dev))
    for d in range(D):
        for _ in range(window):
            acc = ops._wdbl(acc)
        acc = ops._wadd(acc, wsum[:, d])
    return ops._canon(acc)


FOLD_TEAMS = 32  # teams of a bucket_fold block (csrc/bucket.cu FOLD_TEAMS)
_FOLD_MAX_GROUPS = 8  # Horner groups: the teams of one warp
_TEAM_MAX_BUCKETS = 64  # a team a bucket: at most 256 threads a block
# team rounds of a doubling and an add, by coordinates (curve.cuh): RCB
# P-256 4 and 5, HWCD Tom-256 3 and 3
_ROUNDS = {3: (4, 5), 4: (3, 3)}


@dataclasses.dataclass(frozen=True)
class BucketPlan:
    """Geometry of the two bucket kernels for N rows at window w:
    :func:`bucket_sums` runs ``lanes`` lanes a bucket (1, or 4: a team);
    :func:`bucket_fold` splits a window's buckets 1..B-1 into ``segs``
    segments, a team each, ``FOLD_TEAMS // segs`` windows a pass and
    ``wpt`` passes (windows a team, one after another) a block, so
    ``blocks_per_row`` blocks a row; it folds the windows by Horner in
    ``groups`` groups of ``ceil(D / groups)`` windows."""

    lanes: int
    segs: int
    wpt: int
    groups: int
    blocks_per_row: int


def _horner_rounds(D: int, window: int, groups: int, dbl: int, add: int) -> int:
    """Team rounds of the grouped Horner's chain: a group's Lg - 1 steps
    (w doublings and an add), then groups - 1 steps of w * Lg doublings
    and an add."""
    Lg = -(-D // groups)
    return (Lg - 1) * (window * dbl + add) + (groups - 1) * (window * Lg * dbl + add)


def bucket_plan(ops: CurveOps, N: int, window: int, teams_resident: int, lanes: int | None = None,
                segs: int | None = None, wpt: int | None = None) -> BucketPlan:
    """The bucket kernels' geometry for N rows at window w.

    ``bucket_sums``: a team of four lanes a bucket up to 64 buckets (a
    block of 4B threads), a lane a bucket beyond.  On the H100 the team
    form was the faster at every shape timed, the card under-filled or
    filled 13 times over (tools/torch_bucket_probe.py; PERF.md): a team
    runs an add in 3 or 5 rounds instead of 11 or 14 products, and a warp
    waits on the longest of 8 buckets instead of 32.  ``bucket_fold``:
    the rows' blocks (N times the blocks a row, 32 teams each) should fit
    ``teams_resident`` (:func:`bucket_teams`) at once, since a row's last
    block holds its place through the Horner and a second wave waits for
    it: the most segments, a power of two up to 32 and B - 1, that fit
    with one pass; where one segment does not fit, the fewest passes
    (windows a team) that do, else one block a row.  ``groups``: the
    Horner grouping with the shortest chain in team rounds, at most 8.
    ``lanes``, ``segs`` and ``wpt`` force the geometry (tests,
    chip_smoke.py and tools/torch_bucket_probe.py)."""
    _check_window(window)
    D, B = n_windows(window), 1 << window
    lanes = _sums_lanes(B, lanes)

    def fits(sg: int, passes: int) -> bool:
        return N * _blocks_per_row(D, sg, passes) * FOLD_TEAMS <= teams_resident

    top = min(FOLD_TEAMS, B - 1)
    if segs is None:
        segs = 1
        while 2 * segs <= top and fits(2 * segs, wpt or 1):
            segs *= 2
    if not 1 <= segs <= top:
        raise ValueError(f"bucket_fold takes 1..{top} segments at window {window}, not {segs}")
    if wpt is None:
        most = -(-D // (FOLD_TEAMS // segs))  # passes for one block a row
        wpt = next((t for t in range(1, most + 1) if fits(segs, t)), most)
    if not 1 <= wpt <= D:
        raise ValueError(f"bucket_fold takes 1..{D} windows a team at window {window}, not {wpt}")
    dbl, add = _ROUNDS[ops.NCOORD]
    groups = min(range(1, min(_FOLD_MAX_GROUPS, D) + 1),
                 key=lambda g: (_horner_rounds(D, window, g, dbl, add), g))
    return BucketPlan(lanes, segs, wpt, groups, _blocks_per_row(D, segs, wpt))


def _sums_lanes(B: int, lanes: int | None) -> int:
    """bucket_sums' lanes a bucket: a team up to 64 buckets, else one."""
    if lanes is None:
        lanes = 4 if B <= _TEAM_MAX_BUCKETS else 1
    if lanes not in (1, 4) or (lanes == 4 and B > _TEAM_MAX_BUCKETS):
        raise ValueError(f"bucket_sums runs 1 lane a bucket, or 4 up to {_TEAM_MAX_BUCKETS} buckets; "
                         f"not {lanes} at {B}")
    return lanes


def fold_rounds(ops: CurveOps, window: int, plan: BucketPlan) -> int:
    """Team rounds on :func:`bucket_fold`'s dependent chain under ``plan``:
    for each of a team's ``wpt`` windows, a segment's running sums (2 adds
    a bucket past its top one), its (lo - 1) * run (a doubling and an add
    a bit past the top one, then an add) and the tree of the window's
    segments; then the grouped Horner."""
    D, B = n_windows(window), 1 << window
    dbl, add = _ROUNDS[ops.NCOORD]
    seg_len = -(-(B - 1) // plan.segs)
    nbits = (((plan.segs - 1) * (B - 1)) // plan.segs).bit_length()  # of the last segment's lo - 1
    mult = (nbits - 1) * (dbl + add) + add if nbits else 0
    tree = (plan.segs - 1).bit_length() * add
    window_rounds = 2 * (seg_len - 1) * add + mult + tree
    return plan.wpt * window_rounds + _horner_rounds(D, window, plan.groups, dbl, add)


def _blocks_per_row(D: int, segs: int, wpt: int) -> int:
    return -(-D // (FOLD_TEAMS // segs * wpt))


def bucket_teams(ops: CurveOps, device) -> int:
    """Teams of ``bucket_fold``'s kernel that a CUDA device keeps resident
    at once: its SMs times the four-warp blocks an SM holds (C entry
    ``zk_bucket_fold_resident_warps``), eight teams a warp."""
    return _resident_warps("zk_bucket_fold_resident_warps", _index(device), ops.curve_id) * 8


def bucket_sums(ops: CurveOps, points: torch.Tensor, digits: torch.Tensor, window: int,
                lanes: int | None = None) -> torch.Tensor:
    """Bucket sums: points [N, T, C, 9] canonical, window digits [N, D, T]
    (uint8, :func:`window_digits`) -> S [N, D, 2^w, C, 9] canonical.

    Kernel ``csrc/bucket.cu`` (replaces the chunk gather and trees of
    ``zkecdsa_tpu/ops/msm_bucket.py:123 _bucket_body_jit``): one block per
    (row, window) lists the terms by bucket in shared memory (a stable
    counting sort), and a team of four lanes (up to 64 buckets) or a lane
    (``lanes`` forces either) adds the points of a bucket from its first; a
    block whose digits all lie below 2^w / L (the top window) gives each
    bucket L units and sums their pieces by a tree.  A CPU tensor takes
    :func:`bucket_sums_plain`."""
    _check_window(window)
    if points.device.type == "cpu":
        return bucket_sums_plain(ops, points, digits, window)
    lib = _build.load()
    _check_points(ops, points)
    N, T = points.shape[0], points.shape[1]
    D, B = n_windows(window), 1 << window
    if tuple(digits.shape) != (N, D, T) or digits.dtype != torch.uint8:
        raise ValueError(f"expected uint8 digits [{N}, {D}, {T}], got {digits.dtype} {tuple(digits.shape)}")
    if digits.device != points.device:
        raise ValueError("points and digits on different devices")
    if T >= 1 << 16:
        raise ValueError(f"bucket_sums takes fewer than 65536 terms a row, got {T}")
    points, digits = points.contiguous(), digits.contiguous()
    lanes = _sums_lanes(B, lanes)
    out = torch.empty((N, D, B, ops.NCOORD, NLIMBS), dtype=torch.int32, device=points.device)
    code = lib.zk_bucket_sums(
        ops.curve_id, lanes, N, T, D, B, points.data_ptr(), digits.data_ptr(), out.data_ptr(),
        _stream(points),
    )
    _build.check(code, "zk_bucket_sums")
    bucket_sums.launches += 1
    bucket_sums.curves[ops.group.name] = bucket_sums.curves.get(ops.group.name, 0) + 1
    return out


bucket_sums.launches = 0
bucket_sums.curves = {}  # launches by curve name


def bucket_fold(ops: CurveOps, S: torch.Tensor, window: int, segs: int | None = None,
                wpt: int | None = None) -> torch.Tensor:
    """Bucket sums [N, D, 2^w, C, 9] -> [N, C, 9]: per window sum_b b * S_b,
    then the windows by Horner.

    Kernel ``csrc/bucket.cu`` (replaces the fold of
    ``zkecdsa_tpu/ops/msm_bucket.py:123 _bucket_body_jit``, ``:144-171``):
    a team of four lanes a segment of a window's buckets (``segs``
    segments and ``wpt`` windows a team, else :func:`bucket_plan`'s), a
    tree of the segments into W_d, then the row's last block folds the D
    windows by Horner in groups.  A CPU tensor takes
    :func:`bucket_fold_plain`."""
    _check_window(window)
    if S.device.type == "cpu":
        return bucket_fold_plain(ops, S, window)
    lib = _build.load()
    _check_points(ops, S)
    N = S.shape[0]
    D, B = n_windows(window), 1 << window
    if tuple(S.shape[:-2]) != (N, D, B):
        raise ValueError(f"expected bucket sums [{N}, {D}, {B}, C, 9], got {tuple(S.shape)}")
    S = S.contiguous()
    plan = bucket_plan(ops, N, window, bucket_teams(ops, S.device), segs=segs, wpt=wpt)
    out = torch.empty((N, ops.NCOORD, NLIMBS), dtype=torch.int32, device=S.device)
    wsum = torch.empty((N, D, ops.NCOORD, NLIMBS), dtype=torch.int32, device=S.device)
    ticket = torch.zeros((N,), dtype=torch.int32, device=S.device)
    code = lib.zk_bucket_fold(ops.curve_id, N, D, B, window, plan.segs, plan.wpt, plan.groups,
                              S.data_ptr(), wsum.data_ptr(), ticket.data_ptr(), out.data_ptr(), _stream(S))
    _build.check(code, "zk_bucket_fold")
    bucket_fold.launches += 1
    bucket_fold.curves[ops.group.name] = bucket_fold.curves.get(ops.group.name, 0) + 1
    return out


bucket_fold.launches = 0
bucket_fold.curves = {}  # launches by curve name


def msm_bucket_rows(ops: CurveOps, points: torch.Tensor, scalars_rows, window: int | None = None) -> torch.Tensor:
    """out[i] = sum_t s[i, t] * P[i, t]: points [N, T, C, 9] canonical,
    scalars as host ints (rows of at most T) -> [N, C, 9]
    (``zkecdsa_tpu/ops/msm_bucket.py:180 msm_bucket_rows``)."""
    T = points.shape[1]
    if window is None:
        window = pick_window(T)
    if len(scalars_rows) != points.shape[0]:
        raise ValueError(f"{len(scalars_rows)} scalar rows for {points.shape[0]} point rows")
    digits = torch.from_numpy(window_digits(scalars_rows, T, window)).to(points.device)
    return bucket_fold(ops, bucket_sums(ops, points, digits, window), window)
