"""Edge operands of the P-256 prime's Solinas product (``csrc/field.cuh``
``fe_mul_p256``), shared by the CPU model test (tests/test_torch_field_p256.py,
which checks what each pair exercises) and the kernels' ``cuda`` tests
(tests/test_torch_kernels.py).  No JAX here."""

P = 2**256 - 2**224 + 2**192 + 2**96 - 1
_ONES = 0xFFFFFFFF


def word_mask(mask: int) -> int:
    """The value with all-ones 32-bit words where ``mask`` has bits (word
    0 = bit 0), reduced mod p."""
    return sum(_ONES << (32 * w) for w in range(8) if (mask >> w) & 1) % P


# word-mask pairs whose products take the reduction's top word h through
# 0..8, its signed form (without the 5p) through -4..3, the fold's carry
# through 0 and 1, and the final subtraction both ways
_MASKS = [
    (124, 124), (48, 160), (49, 164), (24, 160), (19, 189), (17, 181), (12, 128), (9, 171),
    (6, 171), (4, 128), (3, 171), (0, 0), (1, 60), (1, 64), (2, 208), (4, 192), (2, 96),
    (99, 175), (96, 175), (128, 128), (130, 190), (137, 182), (128, 129),
]

SOLINAS_EDGE = [(1, 1), (P - 1, P - 1), (2**256 - 1 - P, 2**256 - 1 - P), (P - 1, P - 2), (0, P - 1)] + [
    (word_mask(a), word_mask(b)) for a, b in _MASKS
]
