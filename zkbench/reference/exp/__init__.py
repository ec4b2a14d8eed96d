from .pointAdd import PointAddProof, aggregate_point_add, prove_point_add, verify_point_add  # noqa: F401
from .exp import ExpProof, prove_exp, verify_exp  # noqa: F401
