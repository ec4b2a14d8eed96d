"""Device parameters and host helpers of the batched pipeline: the parts of
``zkecdsa_tpu/protocol/batch.py`` that the batched verifier uses.

The reference builds its comb tables on the device; here they are built
once per parameter set with the host curve arithmetic (8192 points per
base, affine, then the five mixed-add rows) and uploaded, as the window
tables already were.  The tables are the same group elements either way,
and being affine their canonical coordinates are the same integers.
"""

from __future__ import annotations

import functools

import torch

from ..curves.edwards import TEdwardsPoint
from ..curves.instances import p256, tomEdwards256
from ..curves.weier import WeierstrassPoint
from ..ops.curve_ops import p256_ops, tom_ops
from ..ops.field import FieldT
from ..zkp_attest_list import SystemParametersList

__all__ = ["DeviceParams", "device_params_for", "resolve_device"]

COMB_WINDOWS = 32  # 8-bit windows of a 256-bit scalar
COMB_ENTRIES = 256


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller names
    another.  Raises when CUDA is asked for and absent - no entry point
    falls back to the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the plain "
            "PyTorch versions"
        )
    return dev


class DeviceParams:
    """Device-side precomputation for one SystemParametersList: the window
    table of the P-256 generator G and the mixed-add comb tables of the
    Tom-256 Pedersen bases g and h.  Construct via
    :func:`device_params_for` to share one instance per parameter set and
    device."""

    def __init__(self, params: SystemParametersList, device) -> None:
        self.params = params
        self.device = torch.device(device)
        self.tab_G = self._host_table(p256_ops, p256.generator())
        self.comb_g_tom = self._host_comb_mixed(params.proof_group.g)
        self.comb_h_tom = self._host_comb_mixed(params.proof_group.h)

    def tabs(self) -> dict[str, torch.Tensor]:
        """The tables the verifier phase takes, on the device."""
        return {
            "G": self.tab_G.to(self.device),
            "g_t8": self.comb_g_tom.to(self.device),
            "h_t8": self.comb_h_tom.to(self.device),
        }

    @staticmethod
    def _host_table(ops, base) -> torch.Tensor:
        """[16, C, 9] window table of 0..15 multiples, computed with host
        EC arithmetic (entry k = entry k-1 + base, from the identity)."""
        pts = [base.group.identity()]
        for _ in range(15):
            pts.append(pts[-1].add(base))
        return ops.pack_points(pts)

    @staticmethod
    def _host_comb_mixed(base) -> torch.Tensor:
        """[32, 256, 5, 9] mixed-add comb table: entry [j][d] holds the
        rows (x, y, x+y, d*x*y, a*x) of the affine point d * 2^(8j) * base;
        d = 0 is the affine identity (0, 1)."""
        p = tomEdwards256.p
        rows: list[list[int]] = []
        bj = base
        for _ in range(COMB_WINDOWS):
            pts = [tomEdwards256.identity()]
            for _ in range(COMB_ENTRIES - 1):
                pts.append(pts[-1].add(bj))
            for pt in pts:
                zinv = pow(pt.z, -1, p)
                rows.append(tom_ops.comb_rows(pt.x * zinv % p, pt.y * zinv % p))
            for _ in range(8):
                bj = bj.dbl()
        f = tom_ops.f
        flat = f.pack([v for r in rows for v in r])
        return flat.reshape(COMB_WINDOWS, COMB_ENTRIES, tom_ops.MIXED_NC, -1)


@functools.lru_cache(maxsize=8)
def _device_params_cached(params_json: str, device: str) -> DeviceParams:
    from ..serde import read_json

    return DeviceParams(read_json(SystemParametersList, params_json), device)


def device_params_for(params: SystemParametersList, device) -> DeviceParams:
    """One shared DeviceParams per *content-equal* parameter set and
    device (keyed by the params' canonical wire serialization)."""
    from ..serde import write_json

    return _device_params_cached(
        write_json(SystemParametersList, params), str(torch.device(device))
    )


def _pk_scalars(ctx: FieldT, ints, device) -> torch.Tensor:
    """Host scalars -> canonical [N, 9] limbs on the device."""
    return ctx.pack(ints, device)


def _tom_pt(x: int, y: int) -> TEdwardsPoint:
    return TEdwardsPoint(tomEdwards256, x, y)


def _nist_pt(x: int, y: int) -> WeierstrassPoint:
    return WeierstrassPoint(p256, x, y, 1)


def _unp(ctx: FieldT, arr: torch.Tensor) -> list[int]:
    """Device results (canonical by contract) -> Python ints."""
    return ctx.unpack(arr)
