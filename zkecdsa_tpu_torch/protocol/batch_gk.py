"""Batched Groth-Kohlweiss membership on device: the port of
``zkecdsa_tpu/protocol/batch_gk.py``.

The prover's hot loop is the d-polynomial evaluation (gk.ts:135-171): for
each of n evaluation points w, d(w) = sum_i (v_index - v_i) * p_i(w) with
p_i(w) = prod_j f_{bit_j(i),j}(w).  Since sum_i p_i(w) = prod_j (f0_j +
f1_j), this is v_index * prod_j (f0_j + f1_j) - fold(w), where fold is the
bitwise ring contraction of :func:`zkecdsa_tpu_torch.ops.field.ring_fold`
(one pair-form field_mul launch per ring-index bit).  All N*n points go
through ONE ring_fold call: the n*n factor values per instance are a few
host modular operations each, and the products and differences finish on
the host.  The 4n Pedersen commitments per instance run as one comb-kernel
batch.

The verifier's O(N_ring * n) recombination (gk.ts:239-250) is the same
contraction; the bit relations drain into the caller's MultiMult on the
host.  Both halves give the host path's integers, so
``batch_prove_membership`` emits byte-identical GKProof objects for the
same random tape.
"""

from __future__ import annotations

from typing import Sequence

import torch

from ..bignum import big
from ..commit.pedersen import Commitment, PedersenParams
from ..curves.edwards import TEdwardsPoint
from ..curves.group import hash_points
from ..curves.instances import tomEdwards256
from ..curves.multimult import Relation
from ..ops.curve_ops import comb_mixed, to_affine, tom_ops
from ..ops.field import TOM_N, bytes_le, ring_fold
from ..proofGK.gk import GKProof, _pad, gk_statement_bind
from ..proofGK.interpolate import interpolate
from ..utils import rng
from ..utils.profiling import stages
from .fiat_shamir import challenge_rows, point_bytes

__all__ = [
    "gk_dvalues_device",
    "gk_recombine_device",
    "batch_prove_membership",
    "aggregate_membership",
]

fo = TOM_N


def _ring_len(n_values: int) -> tuple[int, int]:
    pad_len = 1 << (n_values - 1).bit_length() if n_values > 1 else 1
    n = (pad_len - 1).bit_length() if pad_len > 1 else 0
    return pad_len, n


def gk_recombine_device(
    f: torch.Tensor,  # [N, n, 9] response scalars
    xf: torch.Tensor,  # [N, n, 9] x - f
    values: torch.Tensor,  # [RING, 9]
) -> torch.Tensor:
    """total = sum_i v_i * prod_j (f_j if bit_j(i) else x-f_j): [N, 9]
    canonical, mod the Tom-256 order."""
    return ring_fold(values, f, xf)


def gk_dvalues_device(
    eli: list[list[int]],  # [N][n] index bits, LSB first
    ai: list[list[int]],  # [N][n] the prover's a_j
    values: list[int],  # [RING] padded ring values
    v_index: list[int],  # [N] values[which] per instance
    device,
) -> list[list[int]]:
    """d-polynomial values at omega = 0..n-1 per instance: [N][n] ints
    mod the Tom-256 order (gk.ts:135-171).

    Row (i, w) of one ring_fold over N*n rows takes factors1 = f1_j(w) =
    el_j*w + a_j and factors0 = f0_j(w) = (1-el_j)*w - a_j, computed here
    from the host integers; then d = v_index * prod_j (f0_j + f1_j) - fold,
    where f0_j + f1_j = w, so the product is w^n."""
    order = fo.p
    N = len(eli)
    n = len(eli[0]) if N else 0
    f0s, f1s = [], []
    for i in range(N):
        for w in range(n):
            for el, a in zip(eli[i], ai[i]):
                f0s.append(((1 - el) * w - a) % order)
                f1s.append((el * w + a) % order)
    fold = fo.unpack(ring_fold(
        fo.pack(values, device),
        fo.pack(f1s, device).reshape(N * n, n, -1),
        fo.pack(f0s, device).reshape(N * n, n, -1),
    ))
    return [
        [(v_index[i] * pow(w, n, order) - fold[i * n + w]) % order for w in range(n)]
        for i in range(N)
    ]


def _gk_commit_device(tabs, v: torch.Tensor, r: torch.Tensor):
    """Batched Pedersen commits g*v + h*r on the comb kernel, for canonical
    scalar limbs v, r [M, 9], as canonical affine coordinates (x, y)
    [M, 9] (replaces per-instance host double-mults, gk.ts:88-92)."""
    C = comb_mixed(tabs["gh_t8"], torch.cat([bytes_le(v), bytes_le(r)], dim=-1))
    x, y, _ = to_affine(tom_ops, C)
    return x, y


def batch_prove_membership(
    params: PedersenParams,
    coms: Sequence[Commitment],
    indices: Sequence[int],
    initial_values: list[int],
    tapes: Sequence[rng.RandomSource],
    dev,
    timer=None,
) -> list[GKProof]:
    """Batched prover, byte-identical to gk.prove_membership per tape.
    The d-values and the 4n Pedersen commitments per instance (one comb
    batch) run on ``dev.device``; ``dev`` is the parameter set's
    ``protocol.batch.DeviceParams``."""
    stage = stages(timer)
    c = params.c
    order = c.order
    N = len(coms)
    values_s = _pad(initial_values, c)
    RING, n = _ring_len(len(initial_values))

    # tape (reference order: per bit ri, ai, si, ti, rho; gk.ts:112-123)
    ri = [[0] * n for _ in range(N)]
    ai = [[0] * n for _ in range(N)]
    si = [[0] * n for _ in range(N)]
    ti = [[0] * n for _ in range(N)]
    rho = [[0] * n for _ in range(N)]
    with stage("gk.tape"):
        for i, tape in enumerate(tapes):
            d = big.rnd_many([order] * (5 * n), tape)
            for j in range(n):
                ri[i][j], ai[i][j], si[i][j], ti[i][j], rho[i][j] = d[5 * j : 5 * j + 5]
    eli = [[(indices[i] >> j) & 1 for j in range(n)] for i in range(N)]
    if n == 0:  # a ring of one key: no bits, no commitments
        commit_pts = [[] for _ in range(N)]
        x_batch = [hash_points([])] * N
    else:
        with stage("gk.dvalues"):
            dvals = gk_dvalues_device(
                eli, ai, [v.k for v in values_s], [values_s[k].k for k in indices], dev.device
            )
        # interpolate (host; n x n per instance)
        di_all = [interpolate(list(range(n)), dvals[i], order) for i in range(N)]
        with stage("gk.commits"):
            vals: list[int] = []
            blinds: list[int] = []
            for i in range(N):
                vals += eli[i]
                vals += ai[i]
                vals += [eli[i][j] * ai[i][j] % order for j in range(n)]
                vals += list(di_all[i])
                blinds += ri[i] + si[i] + ti[i] + rho[i]
            cx, cy = _gk_commit_device(
                dev.tabs(), fo.pack(vals, dev.device), fo.pack(blinds, dev.device)
            )
            xs, ys = tom_ops.f.unpack(cx), tom_ops.f.unpack(cy)
            commit_pts = [
                [TEdwardsPoint(tomEdwards256, xs[i * 4 * n + t], ys[i * 4 * n + t])
                 for t in range(4 * n)]
                for i in range(N)
            ]
            # challenge x = H(cl || ca || cb || cd) per instance (gk.ts:
            # 179-180; the statement deliberately not hashed, SURVEY 7.5),
            # from the device's affine bytes
            x_batch = challenge_rows([point_bytes(cx, cy, 33).reshape(N, 4 * n * 67)])

    # responses + proof assembly (host)
    with stage("gk.assemble"):
        proofs = []
        for i in range(N):
            row = commit_pts[i]
            cl, ca = row[:n], row[n : 2 * n]
            cb, cd = row[2 * n : 3 * n], row[3 * n : 4 * n]
            x = gk_statement_bind(x_batch[i], coms[i].p, values_s)
            f = [c.new_scalar((eli[i][j] * x + ai[i][j]) % order) for j in range(n)]
            za = [c.new_scalar((ri[i][j] * x + si[i][j]) % order) for j in range(n)]
            zb = [c.new_scalar((ri[i][j] * (x - f[j].k) + ti[i][j]) % order) for j in range(n)]
            zd = coms[i].r.k * pow(x, n, order) % order
            for j in range(n):
                zd = (zd - rho[i][j] * pow(x, j, order)) % order
            proofs.append(GKProof(cl, ca, cb, cd, f, za, zb, c.new_scalar(zd)))
    return proofs


def aggregate_membership(params, com, n: int, proof, x: int,
                         total: int, multi) -> None:
    """Drain the GK bit relations + final relation into ``multi``, given the
    (device-computed) ring recombination ``total`` (gk.ts:223-259).  Length
    checks are the caller's job."""
    c = params.c
    order = c.order
    one = c.new_scalar(1)
    for j in range(n):
        rel0 = Relation(c)
        rel0.insert_m(
            [proof.cl[j], proof.ca[j], params.g, params.h],
            [c.new_scalar(x), one, proof.f[j].neg(), proof.za[j].neg()],
        )
        rel0.drain(multi)
        rel1 = Relation(c)
        rel1.insert_m(
            [proof.cl[j], proof.cb[j], params.h],
            [c.new_scalar((x - proof.f[j].k) % order), one, proof.zb[j].neg()],
        )
        rel1.drain(multi)
    rel_final = Relation(c)
    for j in range(n):
        rel_final.insert(proof.cd[j], c.new_scalar(-pow(x, j, order) % order))
    rel_final.insert(com, c.new_scalar(pow(x, n, order)))
    rel_final.insert_m(
        [params.g, params.h],
        [c.new_scalar(-total % order), proof.zd.neg()],
    )
    rel_final.drain(multi)
