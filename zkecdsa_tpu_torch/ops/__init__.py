from .field import FieldT, P256_N, P256_P, TOM_N, TOM_P, WAR_P, field_mul, ring_fold  # noqa: F401
from .curve_ops import (  # noqa: F401
    EdwardsOps,
    WeierOps,
    byte_digits,
    comb_mixed,
    ec_add,
    nibble_digits,
    p256_ops,
    straus_msm,
    to_affine,
    tom_ops,
    war_ops,
)
