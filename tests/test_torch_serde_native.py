"""The native wire decoder (``runtime/native.cpp`` ``zk_read_proof``) behind
``serde.read_json(SignatureProofList, ...)``: on the canonical wire form it
gives the Python path's proof field by field, and on anything else it
declines, so ``read_json`` gives the same object, or raises the same error,
as the Python path (``from_json_dict`` over ``json.loads``) on every input:
the golden proof and the benchmark's six tamperings, hand-made declines,
values of every digit count, points with tiny and random coordinates, and a
seeded sweep of single-character mutations; the same with the library
reported unavailable; and the counters ``serde.native`` / ``serde.fallback``."""

import ctypes
import hashlib
import json
import random
import re
import shutil
import subprocess
from pathlib import Path

import pytest
import torch

from zkecdsa_tpu_torch import serde
from zkecdsa_tpu_torch.curves.edwards import TEdwardsPoint
from zkecdsa_tpu_torch.curves.group import Scalar
from zkecdsa_tpu_torch.curves.instances import p256, tomEdwards256
from zkecdsa_tpu_torch.curves.weier import WeierstrassPoint
from zkecdsa_tpu_torch.runtime import native
from zkecdsa_tpu_torch.utils import profiling
from zkecdsa_tpu_torch.zkp_attest_list import SignatureProofList

# One intra-op thread: the suite runs several worker processes on the same
# cores, and an oversubscribed OpenMP pool spins instead of working.
torch.set_num_threads(1)

GOLDEN = (Path(__file__).resolve().parent / "vectors" / "golden_proof.json").read_text()

pytestmark = pytest.mark.skipif(shutil.which("g++") is None, reason="no g++ on the PATH: no native decoder to test")


def _dumps(d) -> str:
    return json.dumps(d, separators=(",", ":"))


def _fields(obj, path="proof"):
    """Every leaf of a decoded proof: each point's type, group, x, y, z and
    t, each scalar's group and k, each list's length, absent fields."""
    if obj is None:
        yield path, None
    elif isinstance(obj, WeierstrassPoint):
        yield path, ("W", obj.group, obj.x, obj.y, obj.z)
    elif isinstance(obj, TEdwardsPoint):
        yield path, ("E", obj.group, obj.x, obj.y, obj.z, obj.t)
    elif isinstance(obj, Scalar):
        yield path, ("S", obj.group, obj.k)
    elif isinstance(obj, list):
        yield path + ".len", len(obj)
        for i, v in enumerate(obj):
            yield from _fields(v, f"{path}[{i}]")
    else:
        yield path + ".type", type(obj)
        for name in type(obj).__slots__:
            yield from _fields(getattr(obj, name), f"{path}.{name}")


def _python_path(text):
    return serde.from_json_dict(SignatureProofList, json.loads(text))


def _outcome(parse, text):
    try:
        return "ok", list(_fields(parse(text)))
    except Exception as exc:  # the error itself is the outcome compared
        return "raised", type(exc), str(exc)


def _read(text):
    return serde.read_json(SignatureProofList, text)


# ---------- the benchmark's tamperings, as zkbench/harness/traffic.py makes them ----------

def _tamper(wire: str, kind: str) -> str:
    d = json.loads(wire)
    rounds = d["expProof"]
    if kind == "exp_commit":
        rounds[0]["A"], rounds[1]["A"] = rounds[1]["A"], rounds[0]["A"]
    elif kind in ("exp_response", "exp_round"):
        pick = int.from_bytes(hashlib.sha256(wire.encode()).digest()[:4], "big") % len(rounds)
        for r in rounds if kind == "exp_response" else [rounds[pick]]:
            for a, b in (("alpha", "beta1"), ("z", "z2")):
                if a in r and b in r:
                    r[a], r[b] = r[b], r[a]
    elif kind == "point_add":
        for r in rounds:
            if "proof" in r:
                pi = r["proof"]["pi_8"]
                pi["t_x"], pi["t_y"] = pi["t_y"], pi["t_x"]
    elif kind == "gk_response":
        f = d["membershipProof"]["f"]
        f[0], f[1] = f[1], f[0]
    elif kind == "gk_length":
        d["membershipProof"]["cl"].pop()
    return _dumps(d)


@pytest.mark.parametrize(
    "kind", [None, "exp_commit", "exp_response", "exp_round", "point_add", "gk_response", "gk_length"]
)
def test_native_equals_python_path_field_by_field(kind):
    """The golden proof and each tampering take the native pass, give the
    Python path's proof in every field, and write back byte for byte."""
    text = GOLDEN if kind is None else _tamper(GOLDEN, kind)
    assert native.read_proof(text) is not None, native.error()
    got = _read(text)
    want = _python_path(text)
    assert list(_fields(got)) == list(_fields(want))
    assert serde.write_json(SignatureProofList, got) == text


def test_native_constants_are_the_instances():
    """The primes and curve constants typed into native.cpp are those of
    ``curves/instances.py``."""
    src = native.SRC.read_text()
    for name, g, consts in (("Weierstrass kP256", p256, (p256.p, p256.a, p256.b)),
                            ("TwistedEdwards kTom256", tomEdwards256, (tomEdwards256.p, tomEdwards256.a,
                                                                       tomEdwards256.d))):
        body = src[src.index(f"const {name}(") :].split(";", 1)[0]
        assert [int(h, 16) for h in re.findall(r'"([0-9a-f]+)"', body)] == list(consts), g.name


# ---------- declines: the Python path's object or error, every time ----------

def _edit(fn):
    d = json.loads(GOLDEN)
    fn(d)
    return _dumps(d)


def _set(path, value):
    def fn(d):
        *head, last = path
        for k in head:
            d = d[k]
        d[last] = value
    return fn


_R = json.loads(GOLDEN)["R"]
_P256_P = f"0x{p256.p:x}"

_DECLINES = {
    "pretty_printed": lambda: json.dumps(json.loads(GOLDEN), indent=1),
    "trailing_newline": lambda: GOLDEN + "\n",
    "reordered_keys": lambda: _dumps({k: v for k, v in reversed(list(json.loads(GOLDEN).items()))}),
    "reordered_point_keys": lambda: _edit(_set(["R"], {"x": _R["x"], "group": _R["group"], "y": _R["y"]})),
    "reordered_optional_fields": lambda: _edit(lambda d: d["expProof"].__setitem__(
        0, {k: d["expProof"][0][k] for k in ("A", "Tx", "Ty", "beta1", "alpha", "beta2", "beta3")})),
    "extra_key": lambda: _edit(_set(["extra"], 1)),
    "extra_key_in_point": lambda: _edit(_set(["R", "z"], "0x1")),
    "duplicate_key": lambda: GOLDEN.replace('{"R":', '{"R":' + _dumps(_R) + ',"R":', 1),
    "unicode_escape": lambda: GOLDEN.replace('"p256"', '"p\\u0032\\u0035\\u0036"', 1),
    "non_ascii": lambda: GOLDEN.replace('"p256"', '"p256\u00e9"', 1),
    "uppercase_hex": lambda: _edit(_set(["R", "x"], _R["x"].upper().replace("0X", "0x"))),
    "uppercase_prefix": lambda: _edit(_set(["R", "x"], "0X" + _R["x"][2:])),
    "signed_hex": lambda: _edit(_set(["R", "x"], "-" + _R["x"])),
    "space_in_hex": lambda: _edit(_set(["R", "x"], "0x " + _R["x"][2:])),
    "empty_hex": lambda: _edit(_set(["expProof", 0, "alpha", "k"], "0x")),
    "hex_as_number": lambda: _edit(_set(["expProof", 0, "alpha", "k"], 5)),
    "x_plus_p": lambda: _edit(_set(["R", "x"], f"0x{int(_R['x'], 16) + p256.p:x}")),
    "y_plus_one": lambda: _edit(_set(["R", "y"], f"0x{int(_R['y'], 16) + 1:x}")),
    "tom_y_plus_one": lambda: _edit(_set(["keyXcom", "y"], f"0x{int(json.loads(GOLDEN)['keyXcom']['y'], 16) + 1:x}")),
    "p256_identity": lambda: _edit(_set(["R"], {"group": {"name": "p256"}, "x": "0x0", "y": "0x1"})),
    "coordinate_p": lambda: _edit(_set(["R"], {"group": {"name": "p256"}, "x": _P256_P, "y": _R["y"]})),
    "group_war256": lambda: _edit(_set(["R", "group", "name"], "war256")),
    "group_unknown": lambda: _edit(_set(["R", "group", "name"], "p384")),
    "scalar_group_unknown": lambda: _edit(_set(["expProof", 0, "alpha", "group", "name"], "nope")),
    "missing_required": lambda: _edit(lambda d: d["expProof"][3].pop("Tx")),
    "missing_gk_field": lambda: _edit(lambda d: d["membershipProof"].pop("zd")),
    "null_required": lambda: _edit(_set(["R", "x"], None)),
    "null_optional": lambda: _edit(_set(["expProof", 0, "alpha"], None)),
    "list_for_point": lambda: _edit(_set(["R"], [])),
    "scalar_too_long": lambda: _edit(_set(["expProof", 0, "alpha", "k"], "0x1" + "f" * 66)),
    "truncated_end": lambda: GOLDEN[:-1],
    "truncated_mid": lambda: GOLDEN[: len(GOLDEN) // 2],
    "truncated_in_hex": lambda: GOLDEN[: GOLDEN.index('"x":"0x') + 20],
    "empty": lambda: "",
}


@pytest.mark.parametrize("case", list(_DECLINES))
def test_declines_give_the_python_paths_outcome(case):
    text = _DECLINES[case]()
    assert native.read_proof(text) is None
    assert _outcome(_read, text) == _outcome(_python_path, text)


# ---------- accepted edges: digit counts, leading zeros, tiny and random points ----------

@pytest.mark.parametrize("digits", [1, 2, 15, 16, 17, 31, 32, 33, 48, 63, 64, 65, 66])
def test_every_digit_count_is_read_as_python_reads_it(digits):
    """A scalar of 1-66 hex digits (past 16 the decoder takes sixteen at a
    time, the first chunk short), with and without leading zeros."""
    for k in ("f" * digits, "0" * 40 + "9a" * (digits // 2) + "b" * (digits % 2)):
        text = _edit(_set(["expProof", 0, "alpha", "k"], "0x" + k))
        assert native.read_proof(text) is not None
        assert _outcome(_read, text) == _outcome(_python_path, text)


def _point(g, x, y):
    return {"group": {"name": g.name}, "x": f"0x{x:x}", "y": f"0x{y:x}"}


def test_tiny_and_random_points_are_read_as_python_reads_them():
    """Tom-256's (0, 1) and (0, p - 1), and points k G on both curves with
    seeded k, in place of the golden proof's: the native pass takes each,
    and gives the Python path's proof."""
    rnd = random.Random(20)
    tom, p = tomEdwards256, tomEdwards256.p
    cases = [(["keyXcom"], _point(tom, 0, 1)), (["keyYcom"], _point(tom, 0, p - 1))]
    for g, path in ((p256, ["R"]), (tom, ["expProof", 0, "A"]), (p256, ["comS1"]), (tom, ["membershipProof", "cl", 0])):
        for _ in range(3):
            x, y = g.generator().mul(g.new_scalar(rnd.randrange(1, g.order))).to_affine()
            cases.append((path, _point(g, x, y)))
    for path, pt in cases:
        text = _edit(_set(path, pt))
        assert native.read_proof(text) is not None, (path, pt)
        assert _outcome(_read, text) == _outcome(_python_path, text)


def test_the_build_without_sse2_reads_as_the_sse2_build(tmp_path, monkeypatch):
    """``native.cpp`` built without its SSE2 digit path (as on a host
    other than x86) gives the same flat output, and declines the same."""
    so = tmp_path / "lib.so"
    subprocess.run(["g++", "-O3", "-shared", "-fPIC", "-std=c++17", "-pthread", "-U__SSE2__", str(native.SRC),
                    "-o", str(so)], check=True, timeout=120)
    texts = [GOLDEN, _tamper(GOLDEN, "gk_length"), _DECLINES["y_plus_one"](), _DECLINES["scalar_too_long"]()]
    texts += [_edit(_set(["expProof", 0, "alpha", "k"], "0x" + "0" * z + ("9a" * 33)[:n])) for z, n in
              ((0, 1), (0, 17), (3, 33), (40, 66))]
    assert native.available(), native.error()
    want = [native.read_proof(t) for t in texts]
    assert [w is None for w in want] == [False, False, True, True, False, False, False, False]
    lib = ctypes.CDLL(str(so))
    lib.zk_read_proof.argtypes = native._lib.zk_read_proof.argtypes
    lib.zk_read_proof.restype = ctypes.c_int
    monkeypatch.setattr(native, "_lib", lib)
    assert [native.read_proof(t) for t in texts] == want


# ---------- the mutation sweep ----------

_ALPHABET = '0123456789abcdefABCDEFxX-{}[]:," \\n\u00e9'


@pytest.mark.parametrize("seed", range(4))
def test_single_character_mutations(seed):
    """50 seeded single-character mutations a seed (200 in all) of the
    golden wire: the same object or the same error on both paths."""
    rnd = random.Random(seed)
    for _ in range(50):
        i = rnd.randrange(len(GOLDEN))
        text = GOLDEN[:i] + rnd.choice(_ALPHABET.replace(GOLDEN[i], "")) + GOLDEN[i + 1 :]
        assert _outcome(_read, text) == _outcome(_python_path, text), (i, text[max(0, i - 20) : i + 20])


# ---------- no library, and the counters ----------

def test_without_the_library_read_json_takes_the_python_path(monkeypatch):
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_error", "RuntimeError: reported unavailable")
    assert not native.available() and native.read_proof(GOLDEN) is None
    t = profiling.StageTimer()
    with profiling.tracing(t), profiling.stages(t)("serde"):
        got = _read(GOLDEN)
    assert list(_fields(got)) == list(_fields(_python_path(GOLDEN)))
    assert t.counters[("serde", "serde.fallback")] == 1 and ("serde", "serde.native") not in t.counters
    for case in ("y_plus_one", "pretty_printed"):
        text = _DECLINES[case]()
        assert _outcome(_read, text) == _outcome(_python_path, text)


def test_counters_name_the_path_that_read_the_proof():
    """Under a tracer each proof counts once, ``serde.native`` or
    ``serde.fallback``; ``serde.json_s`` only on the Python path;
    ``serde.native_s`` only on the native one; ``serde.bytes`` on both."""
    t = profiling.StageTimer()
    stage = profiling.stages(t)
    pretty = _DECLINES["pretty_printed"]()
    with profiling.tracing(t):
        with stage("native"):
            _read(GOLDEN)
        with stage("fallback"):
            _read(pretty)
    c = t.counters
    assert c[("native", "serde.native")] == 1 and ("native", "serde.fallback") not in c
    assert 0 < c[("native", "serde.native_s")] < t.stages["native"]
    assert ("native", "serde.json_s") not in c and c[("native", "serde.bytes")] == len(GOLDEN)
    assert c[("fallback", "serde.fallback")] == 1 and ("fallback", "serde.native") not in c
    assert 0 < c[("fallback", "serde.json_s")] < t.stages["fallback"]
    assert ("fallback", "serde.native_s") not in c and c[("fallback", "serde.bytes")] == len(pretty)
