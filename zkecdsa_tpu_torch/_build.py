"""Build and load the port's CUDA kernels.

``nvcc`` compiles each ``csrc/*.cu`` for ``sm_90a`` (all sources at once,
one process each), links them into ``build/zkecdsa_tpu_torch/
libzkkernels.so`` beside the package, and the library is loaded with
``ctypes``: a plain C interface, so the build takes seconds, not the
minutes a source that includes PyTorch's headers would.  The build runs at
the first kernel launch and again only when a source is newer than the
library.  An ``flock`` on ``build.lock`` in the build directory covers the
stale check and the build, so processes started together (the ranks of a
mesh) build once and the others load what it built.

Every C entry returns ``cudaGetLastError()``; :func:`check` raises on a
non-zero code.  A missing ``nvcc`` or a failed build raises: no caller
falls back to a plain version.
"""

from __future__ import annotations

import contextlib
import ctypes
import fcntl
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

__all__ = ["load", "build", "build_lock", "check", "LIB_PATH"]

_PKG = Path(__file__).resolve().parent
_SRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "zkecdsa_tpu_torch"
LIB_PATH = BUILD_DIR / "libzkkernels.so"
LOG_PATH = BUILD_DIR / "nvcc.log"
LOCK_NAME = "build.lock"
_NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas=-v",
]

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
# C entry -> argument types (every pointer and the stream as c_void_p)
_SIGNATURES = {
    "zk_field_mul": [_I, _L, _L, _P, _L, _L, _P, _L, _L, _P, _L, _L, _P, _L, _L, _P, _I, _P],
    "zk_field_mul_chain": [_I, _L, _I, _P, _P, _P, _I, _P],
    "zk_field_sum": [_I, _L, _L, _P, _P, _I, _I, _P],
    "zk_noop": [_I, _I, _P],
    "zk_ring_fold": [_I, _L, _P, _P, _P, _P, _P],
    "zk_ec_add": [_I, _L, _P, _P, _P, _P],
    "zk_tree_sum": [_I, _I, _L, _P, _P, _P],
    "zk_window_table": [_I, _L, _P, _P, _P],
    "zk_to_affine": [_I, _L, _L, _P, _P, _P, _P, _P],
    "zk_to_affine_resident_warps": [_I, _P],
    "zk_straus_msm": [_I, _L, _L, _I, _I, _I, _P, _P, _P, _P, _P],
    "zk_straus_resident_warps": [_I, _P],
    "zk_comb_mixed": [_L, _I, _P, _P, _P, _P],
    "zk_comb_mixed_resident_warps": [_P],
    "zk_comb_weier": [_L, _I, _P, _P, _P, _P],
    "zk_comb_weier_resident_warps": [_P],
    "zk_shamir": [_L, _P, _L, _P, _P, _L, _P, _P, _P],
    "zk_comb4_bases": [_L, _P, _P, _P],
    "zk_comb4_entries": [_L, _I, _P, _P, _P],
    "zk_mul_comb4": [_L, _L, _I, _P, _P, _P, _P],
    "zk_mul_comb4_resident_warps": [_P],
    "zk_comb8_bases": [_I, _L, _P, _P, _P],
    "zk_comb8_entries": [_I, _L, _P, _P, _P, _P],
    "zk_chord": [_L, _P, _P, _P, _P],
    "zk_bucket_sums": [_I, _I, _L, _L, _I, _I, _P, _P, _P, _P],
    "zk_bucket_fold": [_I, _L, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P],
    "zk_bucket_fold_resident_warps": [_I, _P],
    "zk_msm_ladder": [_I, _L, _P, _P, _P, _P],
}

_lib: ctypes.CDLL | None = None
_lock = threading.Lock()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): the "
        "zkecdsa_tpu_torch kernels cannot be built"
    )


def _sources() -> list[Path]:
    return sorted(_SRC.glob("*.cu"))


def _stale() -> bool:
    if not LIB_PATH.exists():
        return True
    built = LIB_PATH.stat().st_mtime
    deps = _sources() + sorted(_SRC.glob("*.cuh"))
    return any(p.stat().st_mtime > built for p in deps)


@contextlib.contextmanager
def build_lock(name: str = LOCK_NAME):
    """Hold the lock file ``name`` in the build directory (``fcntl.flock``,
    exclusive) for the duration: one process at a time checks and builds
    what that lock covers."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd = os.open(BUILD_DIR / name, os.O_RDWR | os.O_CREAT, 0o644)
    try:
        fcntl.flock(fd, fcntl.LOCK_EX)
        yield
    finally:
        os.close(fd)  # closing the descriptor releases the lock


def build() -> float:
    """Compile every source (in parallel) and link the library, under the
    build lock; returns the seconds it took.  Raises RuntimeError with
    nvcc's output on a failure."""
    with build_lock():
        return _build()


def _build() -> float:
    import time

    t0 = time.perf_counter()
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs, procs = [], []
        for src in _sources():
            obj = Path(tmp) / (src.stem + ".o")
            objs.append(str(obj))
            procs.append(subprocess.Popen(
                [nvcc, *_NVCC_FLAGS, "-c", str(src), "-o", str(obj)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            ))
        errors, report = [], []
        for src, proc in zip(_sources(), procs):
            out, _ = proc.communicate()
            report.append(f"== {src.name}\n{out}")
            if proc.returncode != 0:
                errors.append(f"{src.name}:\n{out}")
        # ptxas' register, shared-memory and spill report of every kernel
        LOG_PATH.write_text("\n".join(report))
        if errors:
            raise RuntimeError("nvcc failed:\n" + "\n".join(errors))
        tmp_lib = Path(tmp) / LIB_PATH.name
        link = subprocess.run(
            [nvcc, *_NVCC_FLAGS, "-shared", *objs, "-o", str(tmp_lib)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        if link.returncode != 0:
            raise RuntimeError("nvcc link failed:\n" + link.stdout)
        os.replace(tmp_lib, LIB_PATH)  # atomic: a reader never sees half a file
    return time.perf_counter() - t0


def load() -> ctypes.CDLL:
    """The kernel library, built first if it is missing or stale."""
    global _lib
    with _lock:
        if _lib is None:
            with build_lock():
                if _stale():
                    _build()
            lib = ctypes.CDLL(str(LIB_PATH))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = lib
    return _lib


def check(code: int, name: str) -> None:
    """Raise if a C entry reported a CUDA error."""
    if code != 0:
        raise RuntimeError(f"{name}: CUDA error {code}")
