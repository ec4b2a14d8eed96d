from .interpolate import eval_poly, interpolate  # noqa: F401
from .gk import GKProof, prove_membership, verify_membership  # noqa: F401
