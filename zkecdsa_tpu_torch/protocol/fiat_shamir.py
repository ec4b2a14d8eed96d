"""Vectorized Fiat-Shamir hashing over device-computed point coordinates:
the port's counterpart of ``zkecdsa_tpu/protocol/fiat_shamir.py``.

The reference hashes serialized points one proof element at a time
(reference src/curves/group.ts:221-233 ``hashPoints``: SHA-256 of the
concatenated ``0x04 || x || y`` encodings, first 10 bytes = an 80-bit
challenge).  The batched pipeline produces whole blocks of canonical
affine coordinates at once, as 9 little-endian 32-bit limbs per value
(ops/field.py), so a value's big-endian bytes are its limb bytes reversed
and cut to width: no host point object is built.

Byte-exactness contract: ``be_bytes`` gives exactly
``big.to_bytes(value, nbytes)`` for every canonical row, and
``challenge_rows`` equals ``hash_points`` on the corresponding host points.
As in the reference's batched path, a Weierstrass identity is serialized
as its ``(0, 0)`` affine pair (what ``to_affine`` returns for infinity),
not as the host encoding's single zero byte.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.field import NLIMBS
from ..runtime import native

__all__ = ["be_bytes", "point_bytes", "challenge_rows", "PREFIX"]

PREFIX = np.uint8(0x04)


def be_bytes(arr, nbytes: int) -> np.ndarray:
    """Canonical limbs [..., 9] (a tensor or an array of int32) ->
    big-endian bytes [M, nbytes] (leading dims flattened).  The value must
    fit ``nbytes``: every canonical value of the curve fields does."""
    if isinstance(arr, torch.Tensor):
        arr = arr.detach().cpu().numpy()
    a = np.ascontiguousarray(arr, dtype="<i4").reshape(-1, NLIMBS)
    le = a.view(np.uint8).reshape(a.shape[0], 4 * NLIMBS)
    assert not le[:, nbytes:].any(), "value wider than the requested width"
    return np.ascontiguousarray(le[:, nbytes - 1 :: -1])


def point_bytes(x, y, nbytes: int) -> np.ndarray:
    """Affine coordinate blocks -> ``0x04 || x || y`` rows [M, 1 + 2*nbytes]
    (the uncompressed wire encoding both curve families use; weier.ts:74-89,
    edwards.ts:194-203)."""
    bx = be_bytes(x, nbytes)
    by_ = be_bytes(y, nbytes)
    out = np.empty((bx.shape[0], 1 + 2 * nbytes), np.uint8)
    out[:, 0] = PREFIX
    out[:, 1 : 1 + nbytes] = bx
    out[:, 1 + nbytes :] = by_
    return out


def challenge_rows(parts: list[np.ndarray]) -> list[int]:
    """One 80-bit Fiat-Shamir challenge per row: SHA-256 of the
    concatenated parts (each [M, k_i] uint8), first 10 bytes as a
    big-endian integer (group.ts:230-233)."""
    msg = parts[0] if len(parts) == 1 else np.concatenate(parts, axis=1)
    digests = native.sha256_rows(msg)
    return [int.from_bytes(row.tobytes(), "big") for row in digests[:, :10]]
