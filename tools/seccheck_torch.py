"""Static security gate over the PyTorch port: a standalone copy of
tools/seccheck.py (CI parity with the reference's CodeQL + semgrep +
eslint-plugin-security jobs, reference .github/workflows/node.yml:32-50 and
semgrep.yml) with the library at ``zkecdsa_tpu_torch/`` and the randomness
seam at ``zkecdsa_tpu_torch/utils/rng.py``.  It scans the port's library,
its tests (``tests/test_torch_*.py`` and their helper
``tests/torch_mesh_ranks.py``), its tools (``tools/torch_*.py`` and this
file), its examples, its benchmark entry points and ``chip_smoke.py``.

    python3 tools/seccheck_torch.py

bandit/semgrep are not in the baked-in environment, so this is a small
AST-based scanner with the checks that matter for THIS codebase:

* dangerous dynamic execution: eval/exec/compile-on-strings, os.system,
  subprocess with shell=True;
* unsafe deserialization: pickle.load(s), marshal.loads, yaml.load
  without an explicit safe Loader;
* weak crypto primitives: hashlib.md5/sha1 anywhere in the library;
* randomness-seam bypass: library code (zkecdsa_tpu_torch/, excluding the
  rng seam itself) importing ``random`` or calling ``numpy.random`` - all
  protocol randomness MUST flow through utils.rng so tapes replay;
* tempfile.mktemp (race-prone).

Exit code 1 on any finding.  ``tests/test_torch_seccheck.py`` runs it.
"""

from __future__ import annotations

import ast
import glob
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

LIB_DIRS = ["zkecdsa_tpu_torch"]
# the library, then the port's files outside it (glob patterns)
ALL_DIRS = [
    "zkecdsa_tpu_torch",
    "tests/test_torch_*.py",
    "tests/torch_*.py",
    "tools/torch_*.py",
    "tools/seccheck_torch.py",
    "examples/*_torch.py",
    "bench_cuda.py",
    "bench_components_torch.py",
    "chip_smoke.py",
]
RNG_SEAM = os.path.join("zkecdsa_tpu_torch", "utils", "rng.py")


def _iter_py(dirs):
    for d in dirs:
        path = os.path.join(REPO, d)
        if not os.path.isdir(path):
            yield from sorted(p for p in glob.glob(path) if p.endswith(".py"))
            continue
        for root, _dirs, files in os.walk(path):
            if "__pycache__" in root:
                continue
            for f in files:
                if f.endswith(".py"):
                    yield os.path.join(root, f)


def _call_name(node: ast.Call) -> str:
    f = node.func
    parts = []
    while isinstance(f, ast.Attribute):
        parts.append(f.attr)
        f = f.value
    if isinstance(f, ast.Name):
        parts.append(f.id)
    return ".".join(reversed(parts))


def scan_file(path: str, in_lib: bool) -> list[str]:
    rel = os.path.relpath(path, REPO)
    with open(path, encoding="utf-8") as fh:
        try:
            tree = ast.parse(fh.read())
        except SyntaxError as exc:
            return [f"{rel}: syntax error: {exc}"]
    findings = []
    is_seam = rel == RNG_SEAM
    for node in ast.walk(tree):
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            names = (
                [a.name for a in node.names]
                if isinstance(node, ast.Import)
                else [node.module or ""]
            )
            for name in names:
                if in_lib and not is_seam and name.split(".")[0] == "random":
                    findings.append(
                        f"{rel}:{node.lineno}: stdlib `random` in library "
                        "code - use utils.rng (tape-replayable seam)"
                    )
                if name.split(".")[0] in ("pickle", "marshal") and in_lib:
                    findings.append(
                        f"{rel}:{node.lineno}: {name} import (unsafe "
                        "deserialization) in library code"
                    )
        if not isinstance(node, ast.Call):
            continue
        name = _call_name(node)
        short = name.split(".")[-1]
        if name in ("eval", "exec") or name == "os.system":
            findings.append(f"{rel}:{node.lineno}: call to {name}")
        elif short in ("md5", "sha1") and name.startswith("hashlib"):
            findings.append(f"{rel}:{node.lineno}: weak hash {name}")
        elif name == "tempfile.mktemp":
            findings.append(f"{rel}:{node.lineno}: race-prone mktemp")
        elif short in ("load", "loads") and name.split(".")[0] in (
            "pickle", "marshal"
        ):
            findings.append(f"{rel}:{node.lineno}: unsafe {name}")
        elif name.startswith("yaml.load") and short == "load":
            if not any(k.arg == "Loader" for k in node.keywords):
                findings.append(f"{rel}:{node.lineno}: yaml.load w/o Loader")
        elif short in ("run", "call", "Popen", "check_output", "check_call"):
            for k in node.keywords:
                if (
                    k.arg == "shell"
                    and isinstance(k.value, ast.Constant)
                    and k.value.value is True
                ):
                    findings.append(
                        f"{rel}:{node.lineno}: subprocess {short} shell=True"
                    )
        elif in_lib and not is_seam and name.split(".")[0] in ("np", "numpy"):
            if len(name.split(".")) > 1 and name.split(".")[1] == "random":
                findings.append(
                    f"{rel}:{node.lineno}: numpy.random in library code - "
                    "use utils.rng"
                )
    return findings


def main() -> int:
    findings = []
    lib_files = set(_iter_py(LIB_DIRS))
    for path in _iter_py(ALL_DIRS):
        findings += scan_file(path, in_lib=path in lib_files)
    for f in findings:
        print(f"SECCHECK {f}")
    print(
        f"seccheck: {len(findings)} finding(s) over "
        f"{len(list(_iter_py(ALL_DIRS)))} files"
    )
    return 1 if findings else 0


if __name__ == "__main__":
    sys.exit(main())
