"""The plain reference of the benchmark: a frozen copy of the port's pure
Python host scalar layer (``bignum``, ``curves``, ``commit``, ``exp``,
``proofGK``, ``serde``, ``ecdsa``, ``zkp_attest_list``, ``utils.rng``,
``utils.config``), with its imports made relative to this package and its
DRBG on ``hashlib``.

It imports neither ``jax`` nor the JAX package nor anything of the PyTorch
port, and takes nothing the port made: from the same instances and tapes
it works out every proof and verdict again.  Its module state (the random
source, the configuration) is its own.
"""
