"""JSON wire format (layer L5, reference src/serde.ts + typedjson decorators).

The bit-exactness contract (SURVEY section 3.5):

* integers: ``0x`` + minimal lowercase hex, ``-0x...`` when negative
  (big.ts:230-249);
* scalars: ``{"group": {"name": ...}, "k": "0x..."}``, reduced mod order
  before writing (group.ts:155-157);
* points: affine ``{"group": {"name": ...}, "x": ..., "y": ...}``
  (beforeSerialization toAffine, weier.ts:92-94); re-validated on-curve at
  parse time (afterJson, weier.ts:256-260 / edwards.ts:204-209);
* groups resolve to singletons by name - parsing never constructs groups
  (instances.ts:58-78);
* property order matches the reference's declaration order; compact JSON
  (no whitespace), like ``JSON.stringify``;
* ``ExpProof`` optional response fields are omitted when absent;
* any missing/invalid required field raises.

``read_json(SignatureProofList, text)`` first hands the text to the native
decoder (``runtime/native.py::read_proof``), which reads only the canonical
form above, checking every point on its curve, and builds the proof from
its flat output with no dicts and no Python checks.  Where it declines
(any other text, or no library), the Python path below reads the text, so
every input gives the same object or raises the same error either way.
"""

from __future__ import annotations

import json
import time
from itertools import islice, starmap
from struct import iter_unpack
from typing import Any, Callable, Type, TypeVar

from .bignum.big import hex_to_int, int_to_hex, verify_pos_range
from .commit.equality import EqualityProof
from .commit.mult import MultProof
from .commit.pedersen import PedersenParams
from .curves.edwards import TEdwards, TEdwardsPoint
from .curves.group import Group, Point, Scalar
from .curves.instances import group_by_name, p256, tomEdwards256
from .curves.weier import WeierstrassGroup, WeierstrassPoint
from .exp.exp import ExpProof
from .exp.pointAdd import PointAddProof
from .proofGK.gk import GKProof
from .runtime import native
from .utils import profiling
from .zkp_attest_list import SignatureProofList, SystemParametersList

__all__ = ["read_json", "write_json", "to_json_dict", "from_json_dict"]

T = TypeVar("T")


# ---------- encoding ----------

def _enc_group(g: Group) -> dict:
    return {"name": g.name}


def _enc_point(p: Point) -> dict:
    coord = p.to_affine()
    if coord is None:
        # Weierstrass identity: toAffine leaves (0, 1) behind (weier.ts:232-235).
        x, y = 0, 1
    else:
        x, y = coord
    return {"group": _enc_group(p.group), "x": int_to_hex(x), "y": int_to_hex(y)}


def _enc_scalar(s: Scalar) -> dict:
    return {"group": _enc_group(s.group), "k": int_to_hex(s.k)}


def _enc_pedersen(pp: PedersenParams) -> dict:
    return {"c": _enc_group(pp.c), "g": _enc_point(pp.g), "h": _enc_point(pp.h)}


def _enc_equality(pi: EqualityProof) -> dict:
    return {
        "A_1": _enc_point(pi.A_1),
        "A_2": _enc_point(pi.A_2),
        "t_x": _enc_scalar(pi.t_x),
        "t_r1": _enc_scalar(pi.t_r1),
        "t_r2": _enc_scalar(pi.t_r2),
    }


def _enc_mult(pi: MultProof) -> dict:
    out = {}
    for name in ("C_4", "A_x", "A_y", "A_z", "A_4_1", "A_4_2"):
        out[name] = _enc_point(getattr(pi, name))
    for name in ("t_x", "t_y", "t_z", "t_rx", "t_ry", "t_rz", "t_r4"):
        out[name] = _enc_scalar(getattr(pi, name))
    return out


def _enc_point_add(pi: PointAddProof) -> dict:
    return {
        "C_8": _enc_point(pi.C_8),
        "C_10": _enc_point(pi.C_10),
        "C_11": _enc_point(pi.C_11),
        "C_13": _enc_point(pi.C_13),
        "pi_8": _enc_mult(pi.pi_8),
        "pi_10": _enc_mult(pi.pi_10),
        "pi_11": _enc_mult(pi.pi_11),
        "pi_13": _enc_mult(pi.pi_13),
        "pi_x": _enc_equality(pi.pi_x),
        "pi_y": _enc_equality(pi.pi_y),
    }


def _enc_exp(pi: ExpProof) -> dict:
    out = {"A": _enc_point(pi.A), "Tx": _enc_point(pi.Tx), "Ty": _enc_point(pi.Ty)}
    for name in ("alpha", "beta1", "beta2", "beta3", "z", "z2"):
        v = getattr(pi, name)
        if v is not None:
            out[name] = _enc_scalar(v)
    if pi.proof is not None:
        out["proof"] = _enc_point_add(pi.proof)
    for name in ("r1", "r2"):
        v = getattr(pi, name)
        if v is not None:
            out[name] = _enc_scalar(v)
    return out


def _enc_gk(pi: GKProof) -> dict:
    return {
        "cl": [_enc_point(p) for p in pi.cl],
        "ca": [_enc_point(p) for p in pi.ca],
        "cb": [_enc_point(p) for p in pi.cb],
        "cd": [_enc_point(p) for p in pi.cd],
        "f": [_enc_scalar(s) for s in pi.f],
        "za": [_enc_scalar(s) for s in pi.za],
        "zb": [_enc_scalar(s) for s in pi.zb],
        "zd": _enc_scalar(pi.zd),
    }


def _enc_sig_proof(pi: SignatureProofList) -> dict:
    return {
        "R": _enc_point(pi.R),
        "comS1": _enc_point(pi.comS1),
        "keyXcom": _enc_point(pi.keyXcom),
        "keyYcom": _enc_point(pi.keyYcom),
        "expProof": [_enc_exp(p) for p in pi.expProof],
        "membershipProof": _enc_gk(pi.membershipProof),
    }


def _enc_sys_params(sp: SystemParametersList) -> dict:
    return {
        "NistGroup": _enc_pedersen(sp.nist_group),
        "ProofGroup": _enc_pedersen(sp.proof_group),
        "SecLevel": sp.sec_level,
    }


# ---------- decoding ----------

def _req(obj: dict, key: str) -> Any:
    if not isinstance(obj, dict) or key not in obj or obj[key] is None:
        raise ValueError(f"the field {key} is required")
    return obj[key]


def _dec_group(obj: dict) -> Group:
    return group_by_name(_req(obj, "name"))


def _dec_point(obj: dict) -> Point:
    g = _dec_group(_req(obj, "group"))
    x = hex_to_int(_req(obj, "x"))
    y = hex_to_int(_req(obj, "y"))
    if isinstance(g, WeierstrassGroup):
        pt = WeierstrassPoint(g, x, y, 1)
        if not g.is_on_group(pt):
            raise ValueError(f"point not on Weierstrass group: {g.name}")
        return pt
    assert isinstance(g, TEdwards)
    pt = TEdwardsPoint(g, x, y, x * y % g.p, 1)
    if not g.is_on_group(pt):
        raise ValueError(f"point not on TEdwards group: {g.name}")
    return pt


def _dec_scalar(obj: dict) -> Scalar:
    g = _dec_group(_req(obj, "group"))
    return g.new_scalar(hex_to_int(_req(obj, "k")))


def _dec_pedersen(obj: dict) -> PedersenParams:
    return PedersenParams(
        _dec_group(_req(obj, "c")),
        _dec_point(_req(obj, "g")),
        _dec_point(_req(obj, "h")),
    )


def _dec_equality(obj: dict) -> EqualityProof:
    return EqualityProof(
        _dec_point(_req(obj, "A_1")),
        _dec_point(_req(obj, "A_2")),
        _dec_scalar(_req(obj, "t_x")),
        _dec_scalar(_req(obj, "t_r1")),
        _dec_scalar(_req(obj, "t_r2")),
    )


def _dec_mult(obj: dict) -> MultProof:
    pts = [_dec_point(_req(obj, n)) for n in ("C_4", "A_x", "A_y", "A_z", "A_4_1", "A_4_2")]
    scs = [_dec_scalar(_req(obj, n)) for n in ("t_x", "t_y", "t_z", "t_rx", "t_ry", "t_rz", "t_r4")]
    return MultProof(*pts, *scs)


def _dec_point_add(obj: dict) -> PointAddProof:
    return PointAddProof(
        _dec_point(_req(obj, "C_8")),
        _dec_point(_req(obj, "C_10")),
        _dec_point(_req(obj, "C_11")),
        _dec_point(_req(obj, "C_13")),
        _dec_mult(_req(obj, "pi_8")),
        _dec_mult(_req(obj, "pi_10")),
        _dec_mult(_req(obj, "pi_11")),
        _dec_mult(_req(obj, "pi_13")),
        _dec_equality(_req(obj, "pi_x")),
        _dec_equality(_req(obj, "pi_y")),
    )


def _opt(obj: dict, key: str, dec: Callable) -> Any:
    return dec(obj[key]) if key in obj and obj[key] is not None else None


def _dec_exp(obj: dict) -> ExpProof:
    return ExpProof(
        _dec_point(_req(obj, "A")),
        _dec_point(_req(obj, "Tx")),
        _dec_point(_req(obj, "Ty")),
        alpha=_opt(obj, "alpha", _dec_scalar),
        beta1=_opt(obj, "beta1", _dec_scalar),
        beta2=_opt(obj, "beta2", _dec_scalar),
        beta3=_opt(obj, "beta3", _dec_scalar),
        z=_opt(obj, "z", _dec_scalar),
        z2=_opt(obj, "z2", _dec_scalar),
        proof=_opt(obj, "proof", _dec_point_add),
        r1=_opt(obj, "r1", _dec_scalar),
        r2=_opt(obj, "r2", _dec_scalar),
    )


def _dec_gk(obj: dict) -> GKProof:
    return GKProof(
        [_dec_point(p) for p in _req(obj, "cl")],
        [_dec_point(p) for p in _req(obj, "ca")],
        [_dec_point(p) for p in _req(obj, "cb")],
        [_dec_point(p) for p in _req(obj, "cd")],
        [_dec_scalar(s) for s in _req(obj, "f")],
        [_dec_scalar(s) for s in _req(obj, "za")],
        [_dec_scalar(s) for s in _req(obj, "zb")],
        _dec_scalar(_req(obj, "zd")),
    )


def _dec_sig_proof(obj: dict) -> SignatureProofList:
    return SignatureProofList(
        _dec_point(_req(obj, "R")),
        _dec_point(_req(obj, "comS1")),
        _dec_point(_req(obj, "keyXcom")),
        _dec_point(_req(obj, "keyYcom")),
        [_dec_exp(p) for p in _req(obj, "expProof")],
        _dec_gk(_req(obj, "membershipProof")),
    )


def _dec_sys_params(obj: dict) -> SystemParametersList:
    return SystemParametersList(
        _dec_pedersen(_req(obj, "NistGroup")),
        _dec_pedersen(_req(obj, "ProofGroup")),
        int(_req(obj, "SecLevel")),
    )


_ENCODERS: dict[type, Callable[[Any], Any]] = {
    Scalar: _enc_scalar,
    WeierstrassPoint: _enc_point,
    TEdwardsPoint: _enc_point,
    WeierstrassGroup: _enc_group,
    TEdwards: _enc_group,
    PedersenParams: _enc_pedersen,
    EqualityProof: _enc_equality,
    MultProof: _enc_mult,
    PointAddProof: _enc_point_add,
    ExpProof: _enc_exp,
    GKProof: _enc_gk,
    SignatureProofList: _enc_sig_proof,
    SystemParametersList: _enc_sys_params,
}

_DECODERS: dict[type, Callable[[Any], Any]] = {
    Scalar: _dec_scalar,
    WeierstrassPoint: _dec_point,
    TEdwardsPoint: _dec_point,
    Point: _dec_point,
    WeierstrassGroup: _dec_group,
    TEdwards: _dec_group,
    Group: _dec_group,
    PedersenParams: _dec_pedersen,
    EqualityProof: _dec_equality,
    MultProof: _dec_mult,
    PointAddProof: _dec_point_add,
    ExpProof: _dec_exp,
    GKProof: _dec_gk,
    SignatureProofList: _dec_sig_proof,
    SystemParametersList: _dec_sys_params,
}


def to_json_dict(obj: Any) -> Any:
    for cls in type(obj).__mro__:
        if cls in _ENCODERS:
            return _ENCODERS[cls](obj)
    raise TypeError(f"not serializable: {type(obj)}")


def from_json_dict(cls: Type[T], obj: Any) -> T:
    for c in cls.__mro__:
        if c in _DECODERS:
            return _DECODERS[c](obj)
    raise TypeError(f"not deserializable: {cls}")


def write_json(cls: Type[T], obj: T) -> str:
    """Compact JSON, property order as declared (serde.ts:34-36)."""
    return json.dumps(to_json_dict(obj), separators=(",", ":"))


_INT_FORMAT = f"{native.INT_BYTES}s"


def _build_proof(kinds: bytes, ints: bytes, shape: list[int]) -> SignatureProofList:
    """The proof from :func:`native.read_proof`'s flat output: every point
    and scalar in document order, then the containers around them."""
    nx = starmap(int.from_bytes, iter_unpack(_INT_FORMAT, ints)).__next__
    W, E, sp, st = WeierstrassPoint, TEdwardsPoint, p256.new_scalar, tomEdwards256.new_scalar
    vals = iter([
        st(nx()) if k == 3 else E(tomEdwards256, nx(), nx(), None, 1) if k == 1
        else sp(nx()) if k == 2 else W(p256, nx(), nx(), 1)
        for k in kinds
    ])
    v = vals.__next__

    def mult() -> MultProof:
        return MultProof(*islice(vals, 13))

    def equality() -> EqualityProof:
        return EqualityProof(*islice(vals, 5))

    R, comS1, keyXcom, keyYcom = v(), v(), v(), v()
    n = shape[0]
    rounds = []
    for m in shape[1 : 1 + n]:
        rounds.append(ExpProof(
            v(), v(), v(),
            alpha=v() if m & 1 else None,
            beta1=v() if m & 2 else None,
            beta2=v() if m & 4 else None,
            beta3=v() if m & 8 else None,
            z=v() if m & 16 else None,
            z2=v() if m & 32 else None,
            proof=PointAddProof(v(), v(), v(), v(), mult(), mult(), mult(), mult(), equality(), equality())
            if m & 64 else None,
            r1=v() if m & 128 else None,
            r2=v() if m & 256 else None,
        ))
    cl, ca, cb, cd, f, za, zb = (list(islice(vals, k)) for k in shape[1 + n :])
    return SignatureProofList(R, comS1, keyXcom, keyYcom, rounds, GKProof(cl, ca, cb, cd, f, za, zb, v()))


def read_json(cls: Type[T], text: str) -> T:
    """Parse + validate; raises on any invalid content (serde.ts:21-32).
    A ``SignatureProofList`` goes to the native decoder first, and to the
    Python path where it declines (see the module's docstring).
    While a tracer is installed (``utils.profiling.tracing``) it counts
    ``serde.bytes``, the text's length (the wire is ASCII); for a
    ``SignatureProofList`` ``serde.native`` (a proof the native decoder
    read, with ``serde.native_s``, the seconds of its call: the object
    build is the rest) or ``serde.fallback`` (a proof the Python path
    read); and on the Python path ``serde.json_s``, the seconds in
    ``json.loads``: the decode and the checks of every point are the
    rest of its call."""
    traced = profiling.TRACER is not None
    if cls is SignatureProofList:
        t0 = time.perf_counter() if traced else 0.0
        flat = native.read_proof(text)
        if flat is not None:
            if traced:
                profiling.count("serde.native_s", time.perf_counter() - t0)
                profiling.count("serde.native")
                profiling.count("serde.bytes", len(text))
            return _build_proof(*flat)
        if traced:
            profiling.count("serde.fallback")
    if not traced:
        return from_json_dict(cls, json.loads(text))
    t0 = time.perf_counter()
    obj = json.loads(text)
    profiling.count("serde.json_s", time.perf_counter() - t0)
    profiling.count("serde.bytes", len(text))
    return from_json_dict(cls, obj)
