"""Device MSM for the scalar verifier: the port of
``zkecdsa_tpu/protocol/verify.py``.

The scalar verifier (``zkp_attest_list.verify_signature_list``) folds each
proof's sigma-protocol checks into one ``MultiMult`` per check and curve
and evaluates it on the host.  Under :func:`device_msm_backend` every
evaluation of 8 or more terms goes to :func:`device_msm` instead: the
pairs are packed, summed on the card by :func:`~zkecdsa_tpu_torch.ops.
curve_ops.msm` (the Straus kernel on one row), and the sum comes back as
a host point.  This is the latency path of a server that checks each
proof as it arrives; the relation assembly, Fiat-Shamir hashing and GK
recombination stay on the host.

The reference pads each MSM to a multiple of 64 terms so that XLA sees
few shapes; PyTorch has no such need, and padding with (identity, 0)
pairs leaves the sum unchanged, so the port sends the terms as they are.

``batched_verify_signature_list`` verifies a whole batch on the batched
device pipeline (:class:`~zkecdsa_tpu_torch.protocol.batch_verify.
BatchVerifier`).
"""

from __future__ import annotations

import functools
from contextlib import contextmanager
from typing import Sequence

import numpy as np
import torch

from ..curves.group import Group, Point
from ..curves.multimult import set_msm_backend
from ..ops.curve_ops import msm, nibble_digits, p256_ops, tom_ops, war_ops
from ..zkp_attest_list import SignatureProofList, SystemParametersList
from .batch import resolve_device
from .batch_verify import BatchVerifier

__all__ = ["device_msm", "device_msm_backend", "batched_verify_signature_list"]

_OPS = {"p256": p256_ops, "tomEdwards256": tom_ops, "war256": war_ops}


def device_msm(group: Group, points: list[Point], scalars: list[int], device=None) -> Point:
    """sum_i scalars[i] * points[i] on ``device`` (CUDA unless the caller
    names another; ``"cpu"`` runs the plain version), as a host point."""
    dev = resolve_device(device)
    ops = _OPS[group.name]
    arr = ops.pack_points(points, dev)
    digits = torch.from_numpy(nibble_digits(scalars).astype(np.uint8)).to(dev)
    return ops.unpack_points(msm(ops, arr, digits))[0]


@contextmanager
def device_msm_backend(device=None):
    """Within the scope, ``MultiMult.evaluate`` sends an MSM of 8 or more
    terms to :func:`device_msm` on ``device`` (CUDA unless the caller
    names another; raises without a card).  The backend is removed on
    leaving the scope, also on an exception."""
    dev = resolve_device(device)
    set_msm_backend(functools.partial(device_msm, device=dev))
    try:
        yield
    finally:
        set_msm_backend(None)


def batched_verify_signature_list(
    params: SystemParametersList,
    msg_hashes: Sequence[bytes],
    keys: list[int],
    proofs: Sequence[SignatureProofList],
    device=None,
) -> list[bool]:
    """Batched verification on the device pipeline (see
    :mod:`zkecdsa_tpu_torch.protocol.batch_verify`); ``device`` as for
    :class:`~zkecdsa_tpu_torch.protocol.batch_verify.BatchVerifier`."""
    return BatchVerifier(params, device).verify(msg_hashes, keys, proofs)
