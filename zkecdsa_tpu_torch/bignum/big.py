"""Host-side arbitrary-precision modular arithmetic (layer L0).

Python's native ``int`` (CPython's C longobject) plays the role that V8's
BigInt plays for the reference implementation (reference src/bignum/big.ts).
Everything here is *host* math: parameter setup, Fiat-Shamir bookkeeping, and
the scalar correctness anchor the batched GPU kernels are tested against.
The hot batched paths live in :mod:`zkecdsa_tpu_torch.ops` instead.

Behavioral contract (observable, must match the reference exactly):

* Fiat-Shamir challenges are SHA-256 truncated to the first 10 bytes -> 80-bit
  integers (big.ts:136-159, group.ts:221-233).
* ``rnd`` uses rejection sampling over ``byte_len(n)`` bytes (big.ts:171-180).
* hex serde: ``0x`` + lowercase minimal hex, ``-0x...`` for negatives
  (big.ts:230-249).
"""

from __future__ import annotations

import hashlib

from ..utils import profiling, rng

_RND = profiling.Tally("rnd.calls", "rnd.draws")

__all__ = [
    "verify_pos_range",
    "bit_len",
    "byte_len",
    "is_odd",
    "is_even",
    "pos_mod",
    "exp_mod",
    "is_non_negative",
    "absolute",
    "is_square",
    "inv_sqrt_mod",
    "inv_mod",
    "inv_euclid",
    "to_bytes",
    "from_bytes",
    "hash_nums",
    "rnd",
    "rnd_range",
    "is_prime",
    "int_to_hex",
    "hex_to_int",
]


def verify_pos_range(a: int, n: int) -> bool:
    """Check 0 <= a < n, raising otherwise (big.ts:17-22)."""
    if not (0 <= a < n):
        raise ValueError("a not in range")
    return True


def bit_len(n: int) -> int:
    """Bit length; note the reference counts via base-2 string so
    bit_len(0) == 1 (big.ts:23-25)."""
    if n == 0:
        return 1
    if n < 0:
        # '-' + digits: matches `n.toString(2).length` for negatives.
        return (-n).bit_length() + 1
    return n.bit_length()


def byte_len(n: int) -> int:
    return (bit_len(n) + 7) // 8


def is_odd(n: int) -> bool:
    # BigInt `%` truncates toward zero: (-3) % 2 == -1 != 1 -> False (big.ts:29).
    return n >= 0 and n % 2 == 1


def is_even(n: int) -> bool:
    return n % 2 == 0


def pos_mod(n: int, p: int) -> int:
    """Proper non-negative residue (big.ts:36-42). Python's % already
    returns a non-negative result for positive moduli."""
    return n % p


def exp_mod(n: int, e: int, p: int) -> int:
    """n^e mod p, e >= 0 (big.ts:44-59)."""
    if e < 0:
        raise ValueError("neg expo")
    return pow(n, e, p)


def is_non_negative(n: int, p: int) -> bool:
    return 0 <= n <= (p - 1) >> 1


def absolute(n: int, p: int) -> int:
    return n if is_non_negative(n, p) else pos_mod(-n, p)


def is_square(n: int, p: int) -> bool:
    """Euler's criterion (big.ts:68-71)."""
    return pow(n, (p - 1) >> 1, p) == 1


def inv_sqrt_mod(n: int, p: int) -> int:
    """1/sqrt(n) mod p for p = 3 (mod 4) (big.ts:72-75)."""
    return pow(inv_mod(n, p), (p + 1) >> 2, p)


def inv_euclid(t: int, n: int) -> int:
    """Modular inverse via extended Euclid (big.ts:80-119). Not constant
    time - acceptable here for the same reason as the reference (verifier-side
    and setup use only)."""
    a, c = 1, 0
    x, y = t, n
    while y != 0:
        q = _js_div(x, y)
        a, c = c, a - c * q
        x, y = y, x - q * y
    return a % n


def _js_div(x: int, y: int) -> int:
    """BigInt division truncates toward zero; Python floors. The reference's
    extended Euclid uses BigInt semantics, so emulate truncation."""
    q = abs(x) // abs(y)
    return q if (x >= 0) == (y >= 0) else -q


def inv_mod(n: int, p: int) -> int:
    return inv_euclid(n, p)


def to_bytes(n: int, length: int) -> bytes:
    """Big-endian fixed-length encoding (big.ts:121-135)."""
    if not (length > 0 and 0 <= n < (1 << (8 * length))):
        raise ValueError("number doesn't fit in array")
    return n.to_bytes(length, "big")


def from_bytes(a: bytes) -> int:
    return int.from_bytes(a, "big")


def hash_nums(nums: list[int]) -> int:
    """Fiat-Shamir hash of a list of integers: each encoded as its decimal
    string with a 4-byte big-endian length prefix, SHA-256, first 10 bytes
    as an 80-bit integer (big.ts:136-159)."""
    parts = []
    for v in nums:
        enc = str(v).encode()
        parts.append(len(enc).to_bytes(4, "big"))
        parts.append(enc)
    digest = hashlib.sha256(b"".join(parts)).digest()
    return from_bytes(digest[:10])


def rnd(n: int) -> int:
    """Uniform random in [0, n) by rejection sampling over byte_len(n)
    random bytes (big.ts:171-180). Draws through the rng seam so tests can
    replay the tape deterministically.  While a tracer is installed
    (``utils.profiling.tracing``) it counts ``rnd.calls`` and
    ``rnd.draws``, the attempts, rejected ones included."""
    nbytes = byte_len(n)
    draws = 1
    ret = from_bytes(rng.random_bytes(nbytes))
    while ret >= n:
        draws += 1
        ret = from_bytes(rng.random_bytes(nbytes))
    if profiling.TRACER is not None:
        v = _RND.values
        v[0] += 1
        v[1] += draws
    return ret


def rnd_range(lo: int, hi: int) -> int:
    """Uniform random in [lo, hi] (big.ts:182-185)."""
    return rnd(hi - lo + 1) + lo


def rnd_many(moduli, source=None) -> list[int]:
    """Draw ``rnd(m)`` for each modulus in one pass, consuming EXACTLY the
    byte stream the sequential :func:`rnd` loop would (so deterministic
    tapes replay bit-identically) while paying one ``random_bytes`` call
    and a vectorized accept check instead of ~2,000 per-draw Python
    round-trips per prover instance.

    The optimistic path assumes no rejection: for the two production
    moduli (the P-256 order and the Tom-256 order, both within 2^-32 of
    a power of 256) a draw rejects with probability < 2^-32, checked
    vectorized over the whole tape.  On any rejection the source is
    rewound (deterministic sources expose state()/restore()) and the
    exact sequential loop replays; sources without snapshots fall back
    to sequential draws for the remainder (fresh entropy, no replay
    contract to honor).

    Under a tracer it counts ``rnd.calls`` and ``rnd.draws`` as the
    sequential loop would: a call and a draw a modulus on the accepting
    path.  A replay is all ``rnd``'s to count; without a snapshot this
    counts the accepted prefix and the rejected draw, and ``rnd`` the
    rest."""
    import numpy as np

    src = source if source is not None else rng.get_source()
    moduli = list(moduli)
    if not moduli:
        return []
    distinct = set(moduli)
    k = byte_len(moduli[0])
    if k < 8 or any(byte_len(m) != k for m in distinct):
        # mixed or tiny widths: no vectorized layout; sequential
        with rng.scoped(src):
            return [rnd(m) for m in moduli]
    snap_fn = getattr(src, "state", None)
    snap = snap_fn() if snap_fn is not None else None
    buf = src.random_bytes(k * len(moduli))
    vals = [int.from_bytes(buf[i : i + k], "big") for i in range(0, len(buf), k)]
    rows = np.frombuffer(buf, np.uint8).reshape(len(moduli), k)
    # quick vectorized accept: value < m is certain when the leading
    # 4 bytes are strictly below the leading 4 bytes of every modulus
    # (both production moduli continue 0x00000001/0x00000000 after
    # 0xFFFFFFFF, so equality is ~2^-32 per draw); candidates get the
    # exact check
    heads = rows[:, :4].astype(np.uint32)
    head_val = (
        (heads[:, 0] << 24) | (heads[:, 1] << 16)
        | (heads[:, 2] << 8) | heads[:, 3]
    )
    mhead = min((m >> (8 * (k - 4))) & 0xFFFFFFFF for m in distinct)
    exact = np.nonzero(head_val >= mhead)[0]
    rejected = any(vals[i] >= moduli[i] for i in exact)
    if not rejected:
        if profiling.TRACER is not None:
            v = _RND.values
            v[0] += len(moduli)
            v[1] += len(moduli)
        return vals
    if snap is not None:
        src.restore(snap)
        with rng.scoped(src):
            return [rnd(m) for m in moduli]
    # non-replayable source: keep the accepted prefix, redraw the rest
    for i, m in enumerate(moduli):
        if vals[i] >= m:
            if profiling.TRACER is not None:
                t = _RND.values
                t[0] += i
                t[1] += i + 1
            with rng.scoped(src):
                return vals[:i] + [rnd(mm) for mm in moduli[i:]]
    return vals


def is_prime(n: int, iterations: int = 7) -> bool:
    """Miller-Rabin with random bases (big.ts:187-228)."""
    if n in (2, 3):
        return True
    if n < 2 or n % 2 == 0:
        return False
    d = n - 1
    s = 0
    while d % 2 == 0:
        d >>= 1
        s += 1
    for _ in range(iterations):
        base = rnd(n - 3) + 2
        x = pow(base, d, n)
        if x == 1 or x == n - 1:
            continue
        for _ in range(s):
            x = (x * x) % n
            if x == 1:
                return False
            if x == n - 1:
                break
        else:
            return False
        if x != n - 1:
            return False
    return True


def int_to_hex(v: int) -> str:
    """Wire encoding of integers: '0x' + minimal lowercase hex, with a
    leading '-' for negatives (big.ts:230-240)."""
    if v < 0:
        return "-0x" + format(-v, "x")
    return "0x" + format(v, "x")


def hex_to_int(v: str) -> int:
    """Wire decoding (big.ts:241-248)."""
    if not v:
        raise ValueError("the field is required")
    if v[0] == "-":
        return -int(v[1:], 16)
    return int(v, 16)
