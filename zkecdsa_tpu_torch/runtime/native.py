"""Hashing, OS randomness and the wire decoder for the host layer: the
port's counterpart of ``zkecdsa_tpu/runtime/native.py``, with its
signatures, and :func:`read_proof`.

``native.cpp`` beside this file (SHA-256 from FIPS 180-4, on the x86 SHA
extensions where the CPU has them; many digests on a thread pool; the
decoder of a proof's canonical wire JSON) is built with ``g++`` at first
use into ``build/zkecdsa_tpu_torch/libzkruntime.so``, beside the kernels'
library, and loaded with ``ctypes``.  The build runs again only when the source is
newer than the library.  It holds the build directory's ``runtime.lock``
(``_build.build_lock``), so processes started together build once, and
``g++`` writes a temporary file in the build directory that ``os.replace``
puts in place, so no process loads half a library.  The library hashes a
probe and is used only if its digest is ``hashlib``'s.

Where it cannot be built or fails that check (a machine without a
toolchain), the hashing falls back to ``hashlib``, the reference's
behaviour: the digests are the same bytes either way, so the
``DeterministicSource`` streams (utils/rng.py) stay byte-identical to the
reference package's.  :func:`available` says whether the library runs and
:func:`error` why it does not.  :func:`fill_random` is ``secrets`` on
every machine (see native.cpp).

:func:`read_proof` (``zk_read_proof``) reads a ``SignatureProofList``'s
wire text in the form ``serde.write_json`` emits, checking every point on
its curve, into flat arrays; it returns None for any other text, and
wherever the library is unavailable, and ``serde.read_json`` then takes
its Python path.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import secrets
import subprocess
import tempfile
import threading
import time
from pathlib import Path

import numpy as np

from .. import _build

__all__ = [
    "LIB_PATH",
    "available",
    "build",
    "error",
    "fill_random",
    "read_proof",
    "sha256",
    "sha256_batch",
    "sha256_rows",
]

SRC = Path(__file__).resolve().parent / "native.cpp"
LIB_PATH = _build.BUILD_DIR / "libzkruntime.so"
LOCK_NAME = "runtime.lock"
_CXX_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17", "-pthread"]
_PROBE = b"zkecdsa-tpu-selftest"

_lib: ctypes.CDLL | None = None
_error: str | None = None
_lock = threading.Lock()


def _compile() -> None:
    """``g++`` into a temporary file in the build directory, then moved
    over the library in one step.  The caller holds the lock."""
    fd, tmp = tempfile.mkstemp(dir=_build.BUILD_DIR, prefix=".libzkruntime-", suffix=".so")
    os.close(fd)
    try:
        out = subprocess.run(["g++", *_CXX_FLAGS, str(SRC), "-o", tmp], capture_output=True, text=True)
        if out.returncode != 0:
            raise RuntimeError("g++ failed:\n" + out.stderr)
        os.replace(tmp, LIB_PATH)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def build() -> float:
    """Compile the library now, stale or not, under the lock; returns the
    seconds it took.  Raises on a failure."""
    t0 = time.perf_counter()
    with _build.build_lock(LOCK_NAME):
        _compile()
    return time.perf_counter() - t0


def _load() -> ctypes.CDLL | None:
    """The library, built first if it is missing or stale; None (and
    :func:`error` set) where it cannot be built or fails its check."""
    global _lib, _error
    if _lib is not None or _error is not None:
        return _lib
    with _lock:
        if _lib is not None or _error is not None:
            return _lib
        try:
            with _build.build_lock(LOCK_NAME):
                if not LIB_PATH.exists() or LIB_PATH.stat().st_mtime < SRC.stat().st_mtime:
                    _compile()
            lib = ctypes.CDLL(str(LIB_PATH))
            lib.zk_sha256.argtypes = [ctypes.c_char_p, ctypes.c_size_t, ctypes.c_char_p]
            lib.zk_sha256.restype = None
            lib.zk_sha256_batch.argtypes = [
                ctypes.c_char_p, ctypes.POINTER(ctypes.c_uint64), ctypes.c_size_t,
                ctypes.c_char_p, ctypes.c_int,
            ]
            lib.zk_sha256_batch.restype = None
            lib.zk_read_proof.argtypes = [
                ctypes.c_char_p, ctypes.c_size_t, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_size_t,
                ctypes.c_void_p, ctypes.c_size_t, ctypes.c_void_p,
            ]
            lib.zk_read_proof.restype = ctypes.c_int
            out = ctypes.create_string_buffer(32)
            lib.zk_sha256(_PROBE, len(_PROBE), out)
            if out.raw != hashlib.sha256(_PROBE).digest():
                raise RuntimeError("native sha256 self-check failed")
            _lib = lib
        except Exception as exc:  # no toolchain: the hashlib fallback
            _error = f"{type(exc).__name__}: {exc}"
    return _lib


def available() -> bool:
    """True when the C++ library runs (built, loaded, self-checked)."""
    return _load() is not None


def error() -> str | None:
    """Why the library is not used, or None when it is (or has not been
    tried yet)."""
    return _error


def _threads(threads: int | None) -> int:
    return min(os.cpu_count() or 1, 16) if threads is None else threads


def sha256(data: bytes) -> bytes:
    """SHA-256 of ``data``."""
    lib = _load()
    if lib is None:
        return hashlib.sha256(data).digest()
    out = ctypes.create_string_buffer(32)
    lib.zk_sha256(data, len(data), out)
    return out.raw


def sha256_batch(messages: list[bytes], threads: int | None = None) -> list[bytes]:
    """SHA-256 of each message, on the C++ thread pool (``threads``
    workers, min(cpu_count, 16) when None) where the library runs."""
    lib = _load()
    if lib is None or not messages:
        return [hashlib.sha256(m).digest() for m in messages]
    M = len(messages)
    offs = np.zeros(M + 1, np.uint64)
    np.cumsum([len(m) for m in messages], out=offs[1:])
    blob = b"".join(messages) or b"\0"  # never a null buffer
    out = ctypes.create_string_buffer(32 * M)
    lib.zk_sha256_batch(blob, offs.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)), M, out,
                        _threads(threads))
    raw = out.raw
    return [raw[32 * i : 32 * i + 32] for i in range(M)]


def sha256_rows(arr, threads: int | None = None) -> np.ndarray:
    """Hash every row of a uint8 matrix [M, K]: returns [M, 32] uint8.

    The fixed-stride form of :func:`sha256_batch` for the batched
    prover's Fiat-Shamir rows and the DRBG's counter blocks: one
    contiguous buffer and an offset vector, no Python bytes per row."""
    a = np.ascontiguousarray(arr, dtype=np.uint8)
    M, K = a.shape
    out = np.empty((M, 32), np.uint8)
    if M == 0:
        return out
    lib = _load()
    if lib is None:
        buf = a.tobytes()
        for i in range(M):
            out[i] = np.frombuffer(hashlib.sha256(buf[i * K : (i + 1) * K]).digest(), np.uint8)
        return out
    if K == 0:  # M empty messages: a one-byte buffer stands in for the data
        a = np.zeros((1, 1), np.uint8)
    offs = np.arange(M + 1, dtype=np.uint64) * np.uint64(K)
    lib.zk_sha256_batch(
        a.ctypes.data_as(ctypes.c_char_p),
        offs.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        M,
        out.ctypes.data_as(ctypes.c_char_p),
        _threads(threads),
    )
    return out


def fill_random(n: int) -> bytes:
    """``n`` bytes from the OS CSPRNG (``secrets``, getrandom on Linux)."""
    return secrets.token_bytes(n)


# The shortest text an integer can take in the wire: half a point,
# ``{"group":{"name":"p256"},"x":"0x0","y":"0x0"}``, is 22.5 characters.
_CHARS_PER_INT = 22
# Bytes an integer in zk_read_proof's output (kIntBytes in native.cpp).
INT_BYTES = 33


def read_proof(text: str) -> tuple[bytes, bytes, list[int]] | None:
    """A ``SignatureProofList``'s wire text in one native pass, or None
    where the library is unavailable or the text is not in the canonical
    form (see native.cpp).  Returns ``(kinds, ints, shape)``: a byte a point
    or scalar in document order (0 a P-256 point, 1 a Tom-256 point, 2 a
    P-256 scalar, 3 a Tom-256 scalar), ``INT_BYTES`` big-endian bytes an
    integer (a point's x and y, a scalar's k), and the rounds' count, each
    round's mask of its optional fields (bit i the i-th of ``alpha, beta1,
    beta2, beta3, z, z2, proof, r1, r2``), then the lengths of ``cl, ca,
    cb, cd, f, za, zb``.  Every point is on its curve, each coordinate
    below its field's prime."""
    if not isinstance(text, str) or not text.isascii():
        return None
    lib = _load()
    if lib is None:
        return None
    data = text.encode("ascii")
    cap = len(data) // _CHARS_PER_INT + 2
    kinds = np.empty(cap, np.uint8)
    ints = np.empty(cap * INT_BYTES, np.uint8)
    shape = np.empty(len(data) // 64 + 16, np.int32)  # a round's text is longer than 64 characters
    counts = np.empty(3, np.uint64)
    if lib.zk_read_proof(data, len(data), kinds.ctypes.data, ints.ctypes.data, cap,
                         shape.ctypes.data, len(shape), counts.ctypes.data):
        return None
    n_kinds, n_ints, n_shape = (int(c) for c in counts)
    return kinds[:n_kinds].tobytes(), ints[: n_ints * INT_BYTES].tobytes(), shape[:n_shape].tolist()
