"""Batched Groth-Kohlweiss membership on device: the port of
``zkecdsa_tpu/protocol/batch_gk.py``.

The prover's hot loop is the d-polynomial evaluation (gk.ts:135-171): for
each of n evaluation points w, d(w) = sum_i (v_index - v_i) * p_i(w) with
p_i(w) = prod_j f_{bit_j(i),j}(w).  Since sum_i p_i(w) = prod_j (f0_j +
f1_j), this is v_index * prod_j (f0_j + f1_j) - fold(w), where fold is the
bitwise ring contraction of :func:`zkecdsa_tpu_torch.ops.field.ring_fold`
(one kernel launch a call).  All N*n points go
through ONE ring_fold call: the n*n factor values per instance are a few
host modular operations each, and the products and differences finish on
the host.  The 4n Pedersen commitments per instance run as one comb-kernel
batch.

The verifier's O(N_ring * n) recombination (gk.ts:239-250) is the same
contraction; the bit relations drain into the caller's MultiMult on the
host.  Both halves give the host path's integers, so
``batch_prove_membership`` emits byte-identical GKProof objects for the
same random tape.

With a mesh (``parallel.mesh``) the instances are sharded over ``dp``, and
when the mesh has a ``ring`` axis the padded ring divides across
(:func:`_ring_sharded`), the d-values run on ``sharded_gk_dvalues`` with
the ring elements sharded too; the outputs are gathered over ``dp``.
"""

from __future__ import annotations

from typing import Sequence

import torch

from ..bignum import big
from ..commit.pedersen import Commitment, PedersenParams
from ..curves.edwards import TEdwardsPoint
from ..curves.group import hash_points
from ..curves.instances import tomEdwards256
from ..curves.multimult import MultiMult, Relation
from ..ops.curve_ops import comb_mixed, to_affine, tom_ops
from ..ops.field import NLIMBS, TOM_N, bytes_le, ring_fold
from ..parallel.mesh import gather, shard_batch, sharded_gk_dvalues
from ..proofGK.gk import GKProof, _pad, gk_statement_bind
from ..proofGK.interpolate import interpolate
from ..utils import rng
from ..utils.profiling import stages
from .batch import resolve_device
from .fiat_shamir import challenge_rows, point_bytes

__all__ = [
    "gk_dvalues_device",
    "gk_recombine_device",
    "batch_prove_membership",
    "batch_verify_membership",
    "aggregate_membership",
]

fo = TOM_N


def _ring_len(n_values: int) -> tuple[int, int]:
    pad_len = 1 << (n_values - 1).bit_length() if n_values > 1 else 1
    n = (pad_len - 1).bit_length() if pad_len > 1 else 0
    return pad_len, n


def _ring_sharded(mesh, RING: int) -> bool:
    """Use the ring-sharded routines when the mesh has a ``ring`` axis of
    more than one rank that the padded ring divides across (reference
    ``protocol/batch_gk.py:54``)."""
    return (
        mesh is not None
        and mesh.shape.get("ring", 1) > 1
        and RING % mesh.shape["ring"] == 0
    )


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
    mesh=None,
) -> list[GKProof]:
    """Batched prover, byte-identical to gk.prove_membership per tape.
    The d-values and the 4n Pedersen commitments per instance (one comb
    batch) run on ``dev.device``; ``dev`` is the parameter set's
    ``protocol.batch.DeviceParams``.  With a ``mesh`` (whose device is
    ``dev.device``) both are sharded over ``dp`` and the d-values over
    ``ring`` when :func:`_ring_sharded`; every rank returns every proof."""
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
            vals = [v.k for v in values_s]
            vidx = [values_s[k].k for k in indices]
            if _ring_sharded(mesh, RING):
                dv = sharded_gk_dvalues(
                    mesh, torch.tensor(eli, dtype=torch.int32),
                    fo.pack([a for row in ai for a in row]).reshape(N, n, -1),
                    fo.pack(vals), fo.pack(vidx), dp_axis="dp",
                )
                flat_d = fo.unpack(gather(mesh, dv))
            else:
                dv = gk_dvalues_device(
                    shard_batch(mesh, eli), shard_batch(mesh, ai), vals, shard_batch(mesh, vidx), dev.device
                )
                flat_d = [d for row in dv for d in row]
                if mesh is not None:  # the dp blocks, in instance order
                    flat_d = fo.unpack(gather(mesh, fo.pack(flat_d)))
            dvals = [flat_d[i * n : (i + 1) * n] for i in range(N)]
        # interpolate (host; n x n per instance)
        di_all = [interpolate(list(range(n)), dvals[i], order) for i in range(N)]
        with stage("gk.commits"):
            vals: list[int] = []
            blinds: list[int] = []
            for i in shard_batch(mesh, range(N)):
                vals += eli[i]
                vals += ai[i]
                vals += [eli[i][j] * ai[i][j] % order for j in range(n)]
                vals += list(di_all[i])
                blinds += ri[i] + si[i] + ti[i] + rho[i]
            cx, cy = (gather(mesh, t) for t in _gk_commit_device(
                dev.tabs(), fo.pack(vals, dev.device), fo.pack(blinds, dev.device)
            ))
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


def batch_verify_membership(
    params: PedersenParams,
    coms: Sequence,  # points
    initial_values: list[int],
    proofs: Sequence[GKProof],
    device=None,
) -> list[bool]:
    """Batched GK verifier (reference ``protocol/batch_gk.py:319``): the
    ring recombination of every proof on ``device`` (CUDA unless the
    caller names another; :func:`gk_recombine_device`), then one host
    ``MultiMult`` of the bit relations per proof.  A proof whose arrays
    are not n long is False."""
    device = resolve_device(device)
    c = params.c
    order = c.order
    N = len(proofs)
    values_s = _pad(initial_values, c)
    n = _ring_len(len(initial_values))[1]
    xs, ok = [], [True] * N
    for i, proof in enumerate(proofs):
        if any(len(arr) != n for arr in (proof.cl, proof.ca, proof.cb, proof.cd, proof.f, proof.za, proof.zb)):
            ok[i] = False
            xs.append(0)
        else:
            xs.append(gk_statement_bind(
                hash_points(proof.cl + proof.ca + proof.cb + proof.cd), coms[i], values_s,
            ))
    f_ints = [proofs[i].f[j].k if ok[i] else 0 for i in range(N) for j in range(n)]
    xf_ints = [(xs[k // n] - v) % order for k, v in enumerate(f_ints)]
    totals = fo.unpack(gk_recombine_device(
        fo.pack(f_ints, device).reshape(N, n, NLIMBS),
        fo.pack(xf_ints, device).reshape(N, n, NLIMBS),
        fo.pack([v.k for v in values_s], device),
    ))
    results = []
    for i, proof in enumerate(proofs):
        if not ok[i]:
            results.append(False)
            continue
        multi = MultiMult(c)
        multi.add_known(params.g)
        multi.add_known(params.h)
        aggregate_membership(params, coms[i], n, proof, xs[i], totals[i], multi)
        results.append(multi.evaluate().is_identity())
    return results


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
