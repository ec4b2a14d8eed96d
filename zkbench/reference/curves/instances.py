"""Curve instances (layer L1).

Constants from the reference (reference src/curves/instances.ts:22-56):

* ``p256`` - NIST P-256, hosts the signature-side commitments.
* ``tomEdwards256`` ("Tom-256") - twisted Edwards curve whose *group order
  equals the P-256 base-field prime*, so Pedersen commitments on it can bind
  P-256 point coordinates.  This is the ProofGroup of the main proof path.
* ``war256`` - Weierstrass curve with the same order as Tom-256; exported as
  an alternative proof group (unused by the main path, matching the
  reference).

Deserialization resolves groups to these singletons *by name*; parsing never
constructs new groups (instances.ts:58-78).
"""

from __future__ import annotations

from .edwards import TEdwards
from .group import Group
from .weier import WeierstrassGroup

__all__ = ["p256", "war256", "tomEdwards256", "ALL_GROUPS", "group_by_name"]

p256 = WeierstrassGroup(
    "p256",
    p=0xFFFFFFFF00000001000000000000000000000000FFFFFFFFFFFFFFFFFFFFFFFF,
    a=0xFFFFFFFF00000001000000000000000000000000FFFFFFFFFFFFFFFFFFFFFFFC,
    b=0x5AC635D8AA3A93E7B3EBBD55769886BC651D06B0CC53B0F63BCE3C3E27D2604B,
    order=0xFFFFFFFF00000000FFFFFFFFFFFFFFFFBCE6FAADA7179E84F3B9CAC2FC632551,
    gen=(
        0x6B17D1F2E12C4247F8BCE6E563A440F277037D812DEB33A0F4A13945D898C296,
        0x4FE342E2FE1A7F9B8EE7EB4A7C0F9E162BCE33576B315ECECBB6406837BF51F5,
    ),
)

war256 = WeierstrassGroup(
    "war256",
    p=0xFFFFFFFF0000000100000000000000017E72B42B30E7317793135661B1C4B117,
    a=0xFFFFFFFF0000000100000000000000017E72B42B30E7317793135661B1C4B114,
    b=0xB441071B12F4A0366FB552F8E21ED4AC36B06ACEEB354224863E60F20219FC56,
    order=0xFFFFFFFF00000001000000000000000000000000FFFFFFFFFFFFFFFFFFFFFFFF,
    gen=(
        0x3,
        0x5A6DD32DF58708E64E97345CBE66600DECD9D538A351BB3C30B4954925B1F02D,
    ),
)

tomEdwards256 = TEdwards(
    "tomEdwards256",
    p=0x3FFFFFFFC000000040000000000000002AE382C7957CC4FF9713C3D82BC47D3AF,
    a=0x1ABCE3FD8E1D7A21252515332A512E09D4249BD5B1EC35E316C02254FE8CEDF5D,
    d=0x051781D9823ABDE00EC99295BA542C8B1401874BCBEB9E9C861174C7BCA6A02AA,
    order=0x0FFFFFFFF00000001000000000000000000000000FFFFFFFFFFFFFFFFFFFFFFFF,
    gen=(
        0x7907055D0A7D4ABC3EAFDC25D431D9659FBE007EE2D8DDC4E906206EA9BA4FDB,
        0xBE231CB9F9BF18319C9F081141559B0A33DDDCCD2221F0464A9CD57081B01A01,
    ),
)

ALL_GROUPS: list[Group] = [p256, war256, tomEdwards256]

_BY_NAME = {g.name: g for g in ALL_GROUPS}


def group_by_name(name: str) -> Group:
    """Singleton resolution used by serde (instances.ts:58-78)."""
    try:
        return _BY_NAME[name]
    except KeyError:
        raise ValueError(f"invalid group name: {name}") from None
