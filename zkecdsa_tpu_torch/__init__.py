"""zkecdsa_tpu_torch - the ZKAttest framework on PyTorch and CUDA.

The counterpart of the JAX package ``zkecdsa_tpu``, module for module:

* host scalar layer (``bignum``/``curves``/``commit``/``exp``/``proofGK``/
  ``serde``/``zkp_attest_list``/``ecdsa``), a copy of the reference
  package's, the exact-semantics anchor;
* device layer (``ops``: 9-limb canonical field values, complete-formula
  curve operations, each hand-written CUDA kernel beside its plain
  PyTorch version; ``protocol``: the batched prover and verifier).

It imports neither JAX nor the reference package.  Device entry points run
on CUDA unless the caller passes ``device="cpu"``.
"""

from .curves.instances import ALL_GROUPS, p256, tomEdwards256, war256  # noqa: F401
from .serde import read_json, write_json  # noqa: F401
from .zkp_attest_list import (  # noqa: F401
    SignatureProofList,
    SystemParametersList,
    generate_params_list,
    prove_signature_list,
    verify_signature_list,
)
from .ecdsa import key_to_int  # noqa: F401

__version__ = "0.1.0"
