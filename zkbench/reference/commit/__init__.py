from .pedersen import Commitment, PedersenParams, generate_pedersen_params  # noqa: F401
from .equality import EqualityProof, aggregate_equality, prove_equality, verify_equality  # noqa: F401
from .mult import MultProof, aggregate_mult, prove_mult, verify_mult  # noqa: F401
