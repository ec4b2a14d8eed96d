"""Batched Groth-Kohlweiss verification on device: the verifier half of
``zkecdsa_tpu/protocol/batch_gk.py``.

The verifier's O(N_ring * n) recombination (gk.ts:239-250) is the bitwise
ring contraction of :func:`zkecdsa_tpu_torch.ops.field.ring_fold` - one
pair-form field_mul launch per ring-index bit - and the bit relations
drain into the caller's MultiMult on the host.
"""

from __future__ import annotations

import torch

from ..curves.multimult import Relation
from ..ops.field import ring_fold

__all__ = ["gk_recombine_device", "aggregate_membership"]


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
