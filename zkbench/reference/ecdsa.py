"""ECDSA over P-256 (host).

The reference delegates keygen/sign/export to WebCrypto
(crypto.subtle, used in reference test/zkpAttestList.test.ts:28-35 and
example/usage.ts) and only consumes raw SEC1 key bytes + raw ``r || s``
signatures inside the library (zkpAttestList.ts:113-123).  This module is
our platform replacement: plain ECDSA with SHA-256, producing exactly those
byte formats.  Randomness flows through the rng seam so signing is
reproducible under a test tape.
"""

from __future__ import annotations

import hashlib

from .bignum import big
from .curves.instances import p256
from .curves.weier import WeierstrassPoint

__all__ = ["KeyPair", "generate_keypair", "sign", "verify", "export_public_raw", "key_to_int"]


class KeyPair:
    __slots__ = ("d", "public")

    def __init__(self, d: int, public: WeierstrassPoint) -> None:
        self.d = d
        self.public = public


def generate_keypair() -> KeyPair:
    d = big.rnd(p256.order - 1) + 1
    pub = p256.generator().mul(p256.new_scalar(d))
    # normalize to affine for export
    x, y = pub.to_affine()
    return KeyPair(d, WeierstrassPoint(p256, x, y, 1))


def export_public_raw(key: KeyPair) -> bytes:
    """Uncompressed SEC1 (0x04 || x || y), the WebCrypto 'raw' format."""
    return key.public.to_bytes()


def _truncate_hash(msg_hash: bytes) -> int:
    z = big.from_bytes(msg_hash)
    excess = len(msg_hash) * 8 - big.bit_len(p256.order)
    if excess > 0:
        z >>= excess
    return z


def sign(key: KeyPair, msg: bytes) -> bytes:
    """ECDSA-SHA256, returns raw r || s (32 + 32 bytes), the WebCrypto
    signature format the proof pipeline parses (zkpAttestList.ts:122-123)."""
    n = p256.order
    z = _truncate_hash(hashlib.sha256(msg).digest())
    while True:
        k = big.rnd(n - 1) + 1
        R = p256.generator().mul(p256.new_scalar(k))
        rx, _ = R.to_affine()
        r = rx % n
        if r == 0:
            continue
        s = big.inv_mod(k, n) * ((z + r * key.d) % n) % n
        if s == 0:
            continue
        return big.to_bytes(r, 32) + big.to_bytes(s, 32)


def verify(public: WeierstrassPoint, msg: bytes, sig: bytes) -> bool:
    n = p256.order
    r = big.from_bytes(sig[: len(sig) // 2])
    s = big.from_bytes(sig[len(sig) // 2 :])
    if not (0 < r < n and 0 < s < n):
        return False
    z = _truncate_hash(hashlib.sha256(msg).digest())
    sinv = big.inv_mod(s, n)
    u1 = z * sinv % n
    u2 = r * sinv % n
    R = p256.generator().mul(p256.new_scalar(u1)).add(public.mul(p256.new_scalar(u2)))
    coord = R.to_affine()
    if coord is None:
        return False
    return coord[0] % n == r


def key_to_int(public_raw: bytes) -> int:
    """Ring entry for a public key: the x-coordinate as an integer
    (zkpAttestList.ts:94-102)."""
    pt = p256.deserialize_point(public_raw)
    coord = pt.to_affine()
    if coord is None:
        raise ValueError("invalid public key")
    return coord[0]
