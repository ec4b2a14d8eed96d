"""What carries across from the reference package: its parameter sets and
its device tables, as the port's objects.

The reference package is not imported here.  Its parameters arrive as the
wire JSON (``zkecdsa_tpu.serde.write_json``), its tables as arrays (numpy,
or anything ``numpy.asarray`` takes) of base-2^7 digits that may be
redundant.
"""

from __future__ import annotations

import numpy as np
import torch

from .ops.field import P256_P, TOM_P, FieldT
from .serde import read_json
from .zkp_attest_list import SystemParametersList

__all__ = ["params_from_jax", "tables_from_jax"]

_DIGIT_BITS = 7  # the reference engine's digit base is 2^7

# table key of the reference DeviceParams.tabs() -> the field of its entries
_TABLE_FIELDS: dict[str, FieldT] = {
    "G": P256_P,
    "h_n": P256_P,
    "h_n8": P256_P,
    "g_t": TOM_P,
    "h_t": TOM_P,
    "g_t8": TOM_P,
    "h_t8": TOM_P,
}


def params_from_jax(params_json: str) -> SystemParametersList:
    """The reference's serialized SystemParametersList as the port's."""
    return read_json(SystemParametersList, params_json)


def _digits_to_limbs(field: FieldT, arr) -> torch.Tensor:
    """[..., L] base-2^7 digits (any non-negative integers) -> canonical
    [..., 9] limbs of the value mod p."""
    a = np.asarray(arr)
    lead = a.shape[:-1]
    d = a.reshape(-1, a.shape[-1]).astype(np.int64).astype(object)
    vals = np.zeros(d.shape[0], dtype=object)
    for k in reversed(range(d.shape[1])):
        vals = vals * (1 << _DIGIT_BITS) + d[:, k]
    return field.pack([int(v) for v in vals]).reshape(lead + (-1,))


def tables_from_jax(tabs: dict) -> dict[str, torch.Tensor]:
    """The reference ``DeviceParams.tabs()`` arrays, reduced to canonical
    values mod each table's field, as the port's limb tensors."""
    return {k: _digits_to_limbs(_TABLE_FIELDS[k], v) for k, v in tabs.items()}
