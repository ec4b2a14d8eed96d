"""The port's native runtime (``zkecdsa_tpu_torch/runtime``): the C++
library builds wherever ``g++`` is on the PATH, its digests are
``hashlib``'s at every thread count and shape the prover and verifier
give it, the DRBG streams are the JAX package's, two processes building at
once leave one good library, and without a toolchain every function falls
back to ``hashlib``/``secrets`` with the same results."""

import ctypes
import hashlib
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from zkecdsa_tpu.bignum import big as jbig
from zkecdsa_tpu.utils import rng as jrng
from zkecdsa_tpu_torch.bignum import big as tbig
from zkecdsa_tpu_torch.runtime import native
from zkecdsa_tpu_torch.utils import rng as trng

# One intra-op thread: the suite runs several worker processes on the same
# cores, and an oversubscribed OpenMP pool spins instead of working.
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
THREADS = (1, 4, None)


def _ref(msgs) -> list[bytes]:
    return [hashlib.sha256(m).digest() for m in msgs]


def test_available_where_gxx_is_on_path():
    if shutil.which("g++") is None:
        pytest.skip("no g++ on the PATH: the hashlib fallback is the documented behaviour")
    assert native.available(), native.error()
    assert native.LIB_PATH.exists() and native.LIB_PATH.parent.name == "zkecdsa_tpu_torch"


# messages of the lengths where SHA-256's padding changes (55, 56, 64
# bytes), empty ones, and ragged ones across several blocks
_BATCHES = {
    "empty_list": [],
    "empty_messages": [b""] * 9,
    "pad_edges": [bytes([i]) * n for i, n in enumerate((0, 1, 55, 56, 57, 63, 64, 65, 119, 120, 128))],
    "ragged": [bytes(range(i % 256)) * (1 + i % 3) for i in range(300)],
    "one": [b"abc"],
}


@pytest.mark.parametrize("threads", THREADS)
@pytest.mark.parametrize("case", list(_BATCHES))
def test_sha256_batch_matches_hashlib(case, threads):
    msgs = _BATCHES[case]
    assert native.sha256_batch(msgs, threads=threads) == _ref(msgs)


@pytest.mark.parametrize("threads", THREADS)
@pytest.mark.parametrize("shape", [(0, 40), (5, 0), (1, 55), (7, 56), (9, 64), (513, 40), (256, 134), (300, 67)])
def test_sha256_rows_matches_hashlib(shape, threads):
    """[M, K] rows: M = 0, empty rows, the padding edges, the DRBG's
    [blocks, 40], the challenge rows (2 x 67 bytes) and the sub-proof
    rows; a strided view is hashed as its rows."""
    a = np.random.RandomState(shape[0] * 1000 + shape[1]).randint(0, 256, shape).astype(np.uint8)
    got = native.sha256_rows(a, threads=threads)
    assert got.shape == (shape[0], 32) and got.dtype == np.uint8
    assert [r.tobytes() for r in got] == _ref(r.tobytes() for r in a)
    wide = np.repeat(a, 2, axis=1)[:, ::2]  # a non-contiguous view of the same rows
    assert np.array_equal(native.sha256_rows(wide, threads=threads), got)


@pytest.mark.parametrize("n", [1, 32, 100, 512, 513, 4096, 70000])
def test_drbg_stream_matches_the_jax_package(n):
    """``DeterministicSource`` (sequential up to 512 bytes, the threaded
    ``sha256_rows`` blocks beyond) gives the JAX package's bytes, draw
    after draw, and so do the bulk modular draws of the prover's tapes."""
    t, j = trng.DeterministicSource(99), jrng.DeterministicSource(99)
    for k in (n, 7, n + 3, 600):
        assert t.random_bytes(k) == j.random_bytes(k)
    moduli = [(1 << 255) - 19, (1 << 256) - 189, 2**252 + 27742317777372353535851937790883648493] * 50
    assert tbig.rnd_many(moduli, t) == jbig.rnd_many(moduli, j)


# the builds of native.cpp: as shipped (the SHA extensions where the CPU
# has them), the scalar rounds only, and each with a thread for any bytes
_BUILDS = {
    "shipped": [],
    "scalar": ["-DZK_SHA256_SCALAR"],
    "threads_always": ["-DZK_MIN_BYTES_PER_THREAD=0"],
    "scalar_threads_always": ["-DZK_SHA256_SCALAR", "-DZK_MIN_BYTES_PER_THREAD=0"],
}


@pytest.mark.parametrize("build", list(_BUILDS))
def test_every_build_of_the_source_matches_hashlib(build, tmp_path):
    """Each compression path and thread policy of ``native.cpp`` gives
    hashlib's digests at every length across three blocks and on batches
    that do and do not start threads."""
    if shutil.which("g++") is None:
        pytest.skip("no g++ on the PATH")
    so = tmp_path / "lib.so"
    subprocess.run(["g++", "-O3", "-shared", "-fPIC", "-std=c++17", "-pthread", *_BUILDS[build],
                    str(native.SRC), "-o", str(so)], check=True, timeout=120)
    lib = ctypes.CDLL(str(so))
    lib.zk_sha256.argtypes = [ctypes.c_char_p, ctypes.c_size_t, ctypes.c_char_p]
    lib.zk_sha256_batch.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_uint64), ctypes.c_size_t,
                                    ctypes.c_char_p, ctypes.c_int]
    rs = np.random.RandomState(3)
    for n in range(200):
        msg = rs.bytes(n)
        out = ctypes.create_string_buffer(32)
        lib.zk_sha256(msg, n, out)
        assert out.raw == hashlib.sha256(msg).digest(), n
    for M, K in ((9, 40), (300, 67), (64, 9000)):
        a = rs.randint(0, 256, (M, K)).astype(np.uint8)
        offs = np.arange(M + 1, dtype=np.uint64) * np.uint64(K)
        out = np.empty((M, 32), np.uint8)
        lib.zk_sha256_batch(a.ctypes.data_as(ctypes.c_char_p), offs.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
                            M, out.ctypes.data_as(ctypes.c_char_p), 4)
        assert [r.tobytes() for r in out] == _ref(r.tobytes() for r in a)


def test_fill_random_draws_fresh_bytes():
    a, b = native.fill_random(64), native.fill_random(64)
    assert len(a) == 64 and a != b
    assert native.fill_random(0) == b""


# Point the runtime at another build directory, then load it: prints
# whether the library runs, why not, and the inode of the loaded file.
_LOAD = r"""
import sys
from pathlib import Path
from zkecdsa_tpu_torch import _build
from zkecdsa_tpu_torch.runtime import native
_build.BUILD_DIR = Path(sys.argv[1])
native.LIB_PATH = _build.BUILD_DIR / "libzkruntime.so"
ok = native.available()
msgs = [b"", b"x" * 56, b"y" * 1000] * 5
import hashlib
assert native.sha256_batch(msgs, threads=4) == [hashlib.sha256(m).digest() for m in msgs]
assert native.sha256(b"abc") == hashlib.sha256(b"abc").digest()
assert len(native.fill_random(16)) == 16
print(ok, native.LIB_PATH.stat().st_ino if ok else None, native.error())
"""


def _loader(build_dir, env=None):
    return subprocess.Popen(
        [sys.executable, "-c", _LOAD, str(build_dir)], cwd=ROOT,
        env=dict(os.environ, PYTHONPATH=str(ROOT), **(env or {})),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
    )


def test_two_processes_building_at_once_leave_one_good_library(tmp_path):
    if shutil.which("g++") is None:
        pytest.skip("no g++ on the PATH")
    procs = [_loader(tmp_path) for _ in range(2)]
    outs = [p.communicate(timeout=180) for p in procs]
    assert all(p.returncode == 0 for p in procs), [err[-2000:] for _, err in outs]
    reports = [out.split() for out, _ in outs]
    assert [r[0] for r in reports] == ["True", "True"]
    assert reports[0][1] == reports[1][1]  # one build: both loaded the same file
    assert sorted(p.name for p in tmp_path.iterdir()) == ["libzkruntime.so", "runtime.lock"]


def test_without_a_toolchain_the_fallback_gives_the_same_results(tmp_path):
    """No g++ on the PATH: the library is not built, ``available()`` is
    False with the reason, and every function still answers (hashlib,
    secrets)."""
    empty = tmp_path / "bin"
    empty.mkdir()
    p = _loader(tmp_path / "build", env={"PATH": str(empty)})
    out, err = p.communicate(timeout=180)
    assert p.returncode == 0, err[-2000:]
    assert out.startswith("False None ") and "g++" in out
    assert not (tmp_path / "build" / "libzkruntime.so").exists()
