"""The batched ZKAttest prover and the device parameters of the batched
pipeline: the port of ``zkecdsa_tpu/protocol/batch.py`` on its unsharded
path (reference src/zkpAttestList.ts:104-145, src/exp/exp.ts:126-231 run
per proof; here the device works on whole batches).

* phase A (device, :func:`phase_a`): R and Q recovery, the commitments and
  the 80 exp rounds' T/A/Tx/Ty for every instance at once, on the Shamir,
  per-base comb, P-256 comb, Tom-256 comb, point-add and affine kernels;
* challenge (host): Fiat-Shamir over the device's affine coordinates;
* phase B (device, :func:`phase_b_flat`): the even-bit rounds of all
  instances as one flat [K] row axis - T1 = T + D, its affine pass and the
  chord-rule field pass (kernel ``chord``, one inverse a row), the 34
  commitments per row and the homomorphic combinations the sub-proof
  hashes need; under a mesh, :func:`phase_b` on the [N, E] layout, which
  shards over the instances;
* GK membership (``batch_gk.batch_prove_membership``): the d-values on the
  ring-fold kernel and the 4n commitments per instance on the comb kernel;
* responses (host): scalar arithmetic and proof assembly, producing the
  same ``SignatureProofList`` objects (and wire bytes) as the host scalar
  prover.

Randomness: each instance draws its tape in exactly the reference's order,
so a batched proof is byte-identical to the host prover's under the same
per-instance source.

With a ``mesh`` (``parallel.mesh``, one process per rank) every rank runs
the host stages on the whole batch and the device stages on its ``dp``
slice of the instances; device outputs are gathered over ``dp`` before the
host reads them, so every rank returns the unsharded prover's proofs.

The comb tables are built on the device once per parameter set, as the
reference builds them (``ops.curve_ops.comb_table``, ``comb_table_mixed``:
the kernels ``comb8_bases`` and ``comb8_entries``); the 16-entry window
table of G is built with the host curve arithmetic and uploaded, as the
reference builds it.  The Tom-256 tables are affine in both packages, so
their canonical coordinates are the same integers, while the reference's
P-256 table of h is projective and the port's is affine (Z = 1).  The
proof wire only carries ``to_affine`` outputs, so the proofs are the same
bytes.
"""

from __future__ import annotations

import functools
from typing import Optional, Sequence

import numpy as np
import torch

from ..bignum import big
from ..commit.equality import EqualityProof
from ..commit.mult import MultProof
from ..commit.pedersen import Commitment
from ..curves.edwards import TEdwardsPoint
from ..curves.instances import p256, tomEdwards256
from ..curves.weier import WeierstrassPoint
from ..exp.exp import ExpProof
from ..exp.pointAdd import PointAddProof
from ..ops.curve_ops import (
    COMB_ENTRIES,
    COMB_WINDOWS,
    MixedComb,
    WeierComb,
    chord,
    comb4_table,
    comb_mixed,
    comb_table,
    comb_table_mixed,
    comb_weier,
    ec_add,
    mul_comb4,
    p256_ops,
    shamir,
    to_affine,
    tom_ops,
    window_table,
)
from ..ops.field import NLIMBS, P256_N, TOM_N, FieldT, bytes_le
from ..parallel.mesh import gather, shard_batch, sharded_gk_dvalues
from ..utils import profiling, rng
from ..utils.profiling import stages
from ..zkp_attest_list import SignatureProofList, SystemParametersList, _truncate_to_n
from .fiat_shamir import challenge_rows, point_bytes

__all__ = [
    "BatchProver",
    "DeviceParams",
    "batched_prove_signature_list",
    "device_params_for",
    "phase_a",
    "phase_b",
    "phase_b_flat",
    "resolve_device",
]

SECPARAM = 80


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
    table of the P-256 generator G (host arithmetic, uploaded), the comb
    table of the P-256 Pedersen base h (a :class:`WeierComb`), and the
    mixed-add comb tables of the Tom-256 Pedersen bases g and h (one
    :class:`MixedComb`), each in canonical and Montgomery form, built on
    ``device`` by the comb kernels (on the CPU, their plain versions).
    Construct via :func:`device_params_for` to share one instance per
    parameter set and device."""

    def __init__(self, params: SystemParametersList, device) -> None:
        self.params = params
        self.device = torch.device(device)
        self.tab_G = self._host_table(p256_ops, p256.generator())
        self.comb_h_nist = comb_table(p256_ops.pack_points([params.nist_group.h], self.device)[0])
        self.comb_gh_tom = comb_table_mixed(
            tom_ops.pack_points([params.proof_group.g, params.proof_group.h], self.device)
        )
        self._tabs: dict[str, torch.Tensor | MixedComb | WeierComb] | None = None

    def tabs(self) -> dict[str, torch.Tensor | MixedComb | WeierComb]:
        """The tables the phases take, on the device: ``comb_h_n8`` is the
        :class:`WeierComb` that ``comb_weier`` takes and ``h_n8`` the view
        of its canonical form; ``gh_t8`` is the :class:`MixedComb` that
        ``comb_mixed`` takes, and ``g_t8`` and ``h_t8`` are views of its
        canonical halves."""
        if self._tabs is None:
            gh = self.comb_gh_tom
            self._tabs = {
                "G": self.tab_G.to(self.device),
                "comb_h_n8": self.comb_h_nist,
                "h_n8": self.comb_h_nist.canon,
                "gh_t8": gh,
                "g_t8": gh.canon[:COMB_WINDOWS],
                "h_t8": gh.canon[COMB_WINDOWS:],
            }
        return self._tabs

    def commit_tom(self, v: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
        """Pedersen commitments g*v + h*r on Tom-256 (reference
        ``protocol/batch.py:142``): canonical values and blindings [..., 9]
        on ``self.device`` -> projective points [..., 4, 9], on the comb
        kernel with the tables of ``tabs()["gh_t8"]``."""
        return comb_mixed(self.tabs()["gh_t8"], torch.cat([bytes_le(v), bytes_le(r)], dim=-1))

    @staticmethod
    def _host_table(ops, base) -> torch.Tensor:
        """[16, C, 9] window table of 0..15 multiples, computed with host
        EC arithmetic (entry k = entry k-1 + base, from the identity)."""
        pts = [base.group.identity()]
        for _ in range(15):
            pts.append(pts[-1].add(base))
        return ops.pack_points(pts)

    @staticmethod
    def _host_comb_weier(base) -> torch.Tensor:
        """[32, 256, 3, 9] P-256 comb table: entry [j][d] is the affine
        point d * 2^(8j) * base with Z = 1; d = 0 is the identity (0:1:0).
        Python-integer curve arithmetic, an independent oracle of the
        canonical form of :func:`comb_table` for the tests and
        chip_smoke.py; no entry point calls it."""
        p = p256.p
        coords: list[int] = []
        bj = base
        for _ in range(COMB_WINDOWS):
            pt = p256.identity()
            coords += [0, 1, 0]
            for _ in range(COMB_ENTRIES - 1):
                pt = pt.add(bj)
                zinv = pow(pt.z, -1, p)
                coords += [pt.x * zinv % p, pt.y * zinv % p, 1]
            for _ in range(8):
                bj = bj.dbl()
        return p256_ops.f.pack(coords).reshape(COMB_WINDOWS, COMB_ENTRIES, 3, -1)

    @staticmethod
    def _host_comb_mixed(base) -> list[int]:
        """The [32, 256, 5] mixed-add comb table, flat: entry [j][d] holds
        the rows (x, y, x+y, d*x*y, a*x) of the affine point d * 2^(8j) *
        base; d = 0 is the affine identity (0, 1).  Python-integer curve
        arithmetic, an independent oracle of :func:`comb_table_mixed` for
        the tests and chip_smoke.py (with :meth:`MixedComb.pack`); no entry
        point calls it."""
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
        return [v for r in rows for v in r]


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


def nibbles(x: torch.Tensor) -> torch.Tensor:
    """MSB-first 4-bit digits of canonical 256-bit limbs: [..., 9] ->
    [..., 64] uint8 (a reinterpretation of the limbs' bytes)."""
    b = bytes_le(x).flip(-1)
    return torch.stack([b >> 4, b & 15], dim=-1).flatten(-2)


# ---------------------------------------------------------------------------
# device phases
# ---------------------------------------------------------------------------


def phase_a(tabs, pk, u1, u2, z1, s1, com_r, pkx_v, pkx_r, pky_v, pky_r,
            alpha, r_rnd, txr, tyr):
    """Phase A of the prover for N instances.  pk [N, 3, 9] P-256 points;
    every scalar is canonical limbs: u1, u2, z1, s1, com_r [N, 9] mod the
    P-256 order; pkx_v, pkx_r, pky_v, pky_r [N, 9] mod the Tom-256 order;
    alpha, r_rnd [N, 80, 9] mod the P-256 order; txr, tyr [N, 80, 9] mod the
    Tom-256 order.  Every ``*_aff`` output is canonical affine limbs."""
    N = pk.shape[0]
    # R = u1*G + u2*PK (zkpAttestList.ts:125-131)
    tab_pk = window_table(p256_ops, pk)
    R = shamir(tabs["G"], nibbles(u1), tab_pk, nibbles(u2))
    tab_R = window_table(p256_ops, R)
    # s1*R and Q = z1*G (zkpAttestList.ts:133-136) as one Shamir call on
    # [N, 2] rows; its second digits are zero and gather only identities
    tp = torch.stack([tab_R, tabs["G"].expand_as(tab_R)], dim=1)  # [N, 2, 16, 3, 9]
    dP = torch.stack([nibbles(s1), nibbles(z1)], dim=1)
    sq = shamir(tp, dP, tabs["G"], torch.zeros_like(dP))
    sR, Q = sq[:, 0], sq[:, 1]
    # comS1 = s1*R + com_r*h (pedersen.ts:53-58 with g := R), and D = Q -
    # comS1 + com_r*h = Q - s1*R: the per-instance constant of the
    # even-round relation T1 = z*R + Q = T + D (see phase_b_flat).  One
    # comb_weier call makes the rounds' r_i * h and com_r * h: [N, 81] rows,
    # com_r's as the 81st of each instance; comS1 and D are one [N, 2] add
    H = comb_weier(tabs["comb_h_n8"], bytes_le(torch.cat([r_rnd, com_r[:, None]], dim=1)))
    Hr, Hc = H[:, :SECPARAM], H[:, SECPARAM]
    cd = ec_add(p256_ops, torch.stack([sR, Q], dim=1), torch.stack([Hc, p256_ops.neg(sR)], dim=1))
    comS1, D = cd[:, 0], cd[:, 1]
    # 80 rounds: T_i = alpha_i * R from a per-instance comb table (on the
    # card in Montgomery form, the form mul_comb4 reads), and A_i = T_i +
    # r_i * h (exp.ts:144-150)
    T = mul_comb4(comb4_table(R), nibbles(alpha))  # [N, 80, 3, 9]
    A = ec_add(p256_ops, T, Hr)
    # one P-256 affine pass: rows [R, Q, comS1] ++ T(80) ++ A(80)
    nx, ny, _ = to_affine(p256_ops, torch.cat([torch.stack([R, Q, comS1], dim=1), T, A], dim=1))
    Tx_v, Ty_v = nx[:, 3:83], ny[:, 3:83]
    # one Tom-256 commit for pkX, pkY and the rounds' Tx/Ty coordinate
    # commitments (exp.ts:151-156): rows [pkX, pkY] ++ [Tx_0, Ty_0, ...];
    # P-256 coordinates are canonical Tom-256 scalars as they stand
    vals = torch.cat(
        [torch.stack([pkx_v, pky_v], dim=1),
         torch.stack([Tx_v, Ty_v], dim=2).reshape(N, 2 * SECPARAM, -1)], dim=1,
    )
    blinds = torch.cat(
        [torch.stack([pkx_r, pky_r], dim=1),
         torch.stack([txr, tyr], dim=2).reshape(N, 2 * SECPARAM, -1)], dim=1,
    )
    allC = comb_mixed(tabs["gh_t8"], torch.cat([bytes_le(vals), bytes_le(blinds)], dim=-1))
    tcx, tcy, _ = to_affine(tom_ops, allC)  # [N, 162, 9]
    return {
        "T": T, "D": D,
        "TC": allC[:, 2:].reshape(N, SECPARAM, 2, 4, -1),
        "pkC": allC[:, :2],
        "small_aff": (nx[:, :3], ny[:, :3]),  # [N, 3 (R, Q, comS1), 9]
        "TA_aff": (
            torch.stack([nx[:, 3:83], nx[:, 83:]], dim=2),
            torch.stack([ny[:, 3:83], ny[:, 83:]], dim=2),
        ),  # [N, 80, 2 (T, A), 9]
        "Tx_v": Tx_v,
        "pk_aff": (tcx[:, :2], tcy[:, :2]),  # [N, 2, 9]
        "TC_aff": (
            tcx[:, 2:].reshape(N, SECPARAM, 2, -1),
            tcy[:, 2:].reshape(N, SECPARAM, 2, -1),
        ),  # [N, 80, 2, 9]
    }


def phase_b_flat(tabs, T, D, TxC, TyC, pkX, pkY, Tx_v, pkx_v, pky_v, pky_r,
                 txr, com_vals, com_blinds, srcid):
    """Phase B over the even-bit rounds of all instances, as one flat [K]
    row axis (the reference's unsharded layout): ``srcid`` [K] holds each
    row's flattened phase-A index i*80 + j, and padding rows repeat the
    last real row.  Per-round device data (T, TxC, TyC, Tx_v and the
    per-round blinding txr [N, 80, 9]) and per-instance data (D, pkX, pkY,
    pkx_v, pky_v, pky_r [N, 9]) are gathered here; com_vals/com_blinds
    [K, BK, 9] are the commit stack in ``_SLOT`` order, with value slots
    0..5 filled here.

    T1 = z*R + Q (exp.ts:190-193) is T + D: one point add per row.  The
    four mult sub-proofs' C4_j = x_j * Cy_j and A42_j = kx_j * Cy_j
    (pointAdd.ts:145-156, mult.ts:105-115) expand the Pedersen commitment
    Cy_j = g*y_j + h*r_j into g*(x*y) + h*(x*r): 8 extra rows of the same
    comb call.  The group elements are the reference's, and the affine pass
    canonicalizes them."""
    NR = T.shape[0] * T.shape[1]
    inst = srcid // SECPARAM  # [K] instance of each row

    def rounds(arr):  # [N, 80, ...] -> [K, ...]
        return arr.reshape((NR,) + arr.shape[2:])[srcid]

    TxC, TyC, Tx_v, T_e, txr_e = map(rounds, (TxC, TyC, Tx_v, T, txr))
    pkX, pkY, D = pkX[inst], pkY[inst], D[inst]
    T1 = ec_add(p256_ops, T_e, D)
    # T1's affine coordinates, the chord-rule intermediates and the C4/A42
    # expansions over the Tom order, one inverse a row (pointAdd.ts:119-136):
    # P := T1 (x1), Q := pk (x2), R := T (x3)
    y = chord(T1, torch.stack(
        [pkx_v[inst], pky_v[inst], Tx_v, pky_r[inst], txr_e]
        + list(com_blinds[:, :4].unbind(1)) + list(com_vals[:, 6:10].unbind(1)),
        dim=1,
    ))
    t1x, t1y = y[:, 0], y[:, 1]
    ints, ext_vals, ext_blinds = y[:, 2:9], y[:, 9:17], y[:, 17:]
    # value slots 0..5: t1x, t1y, i8, i10, i11, i13
    fills = torch.stack([t1x, t1y, ints[:, 1], ints[:, 3], ints[:, 4], ints[:, 6]], dim=1)
    vals = torch.cat([fills, com_vals[:, 6:], ext_vals], dim=1)
    blinds = torch.cat([com_blinds, ext_blinds], dim=1)
    commits = comb_mixed(tabs["gh_t8"], torch.cat([bytes_le(vals), bytes_le(blinds)], dim=-1))
    # [K, BK+8, 4, 9]: slots 26..29 = C4_j, 30..33 = A42_j
    T1xC, T1yC = commits[:, 0], commits[:, 1]
    # homomorphic difference commitments (pointAdd.ts:124-143), hash inputs
    # only: C9 = pkY - T1yC, C12 = T1xC - TxC, C7 = pkX - T1xC,
    # cintX = (TxC + T1xC) + pkX, cintY = TyC + T1yC
    neg = tom_ops.neg
    s = ec_add(
        tom_ops,
        torch.stack([pkY, T1xC, pkX, TxC, TyC], dim=1),
        torch.stack([neg(T1yC), neg(TxC), neg(T1xC), T1xC, T1yC], dim=1),
    )
    cintX = ec_add(tom_ops, s[:, 3], pkX)
    combos = torch.stack([s[:, 2], s[:, 0], s[:, 1], cintX, s[:, 4]], dim=1)
    sx, sy, _ = to_affine(tom_ops, torch.cat([commits, combos], dim=1))  # [K, NSLOT, 9]
    return {"tom_aff": (sx, sy), "ints": ints}


def phase_b(tabs, T, D, TxC, TyC, pkX, pkY, Tx_v, pkx_v, pky_v, pky_r,
            txr, com_vals, com_blinds, eidx):
    """Phase B on the [N, E] even-round layout (reference
    ``protocol/batch.py:308``), the one a mesh shards over the instances:
    ``eidx`` [N, E] holds each instance's even rounds, padded by repeating
    its last one; com_vals/com_blinds are [N, E, BK, 9].  The rows run
    through :func:`phase_b_flat`'s kernels, one launch each over the N*E
    rows; the outputs come back as [N, E, ...].  Unlike the reference,
    ``txr`` is the whole [N, 80, 9] blinding array, selected here as
    phase_b_flat selects it."""
    N, E = eidx.shape
    srcid = (torch.arange(N, device=eidx.device)[:, None] * SECPARAM + eidx).reshape(-1)
    b = phase_b_flat(tabs, T, D, TxC, TyC, pkX, pkY, Tx_v, pkx_v, pky_v, pky_r, txr,
                     com_vals.flatten(0, 1), com_blinds.flatten(0, 1), srcid)
    return {"tom_aff": tuple(t.unflatten(0, (N, E)) for t in b["tom_aff"]),
            "ints": b["ints"].unflatten(0, (N, E))}


# Slot order of the stacked phase-B Pedersen commitments.  Values for slots
# 0..5 are computed on device; the host only supplies blindings there.
# 0 t1x (T1x commit)   1 t1y   2 i8 (C_8)   3 i10 (C_10)   4 i11 (C_11)
# 5 i13 (C_13)   6..9 kx_j (A_x)   10..13 ky_j (A_y)   14..17 kz_j (A_z)
# 18..21 kz_j (A_4_1)   22..23 keq_j (A_1)   24..25 keq_j (A_2)
BK = 26  # commit-stack width
_SLOT = {
    "T1x": 0, "T1y": 1, "C8": 2, "C10": 3, "C11": 4, "C13": 5,
    "Ax": 6, "Ay": 10, "Az": 14, "A41": 18, "A1": 22, "A2": 24,
    "C4": 26, "A42": 30,  # appended after the commit stack in tom_aff
    # device-computed homomorphic combinations (hash inputs only)
    "C7": 34, "C9": 35, "C12": 36, "CIX": 37, "CIY": 38,
}
NSLOT = BK + 13  # commit stack + C4s + A42s + 5 combos


def _flat_rows(k_real: int) -> int:
    """The flat phase-B row count for ``k_real`` even rounds: a multiple
    of 64 up to 512 rows, of 512 beyond, and at least one quantum."""
    quantum = 64 if k_real <= 512 else 512
    return max(quantum, -(-k_real // quantum) * quantum)


# odd 256-bit multiplier of the warm-up's fixed inputs
_WARM_MUL = 0x9E3779B97F4A7C15F39CC0605CEDC8341082276BF3A27251F86C6A11D0C18E95


class _Tape:
    """Per-instance randomness drawn in exactly the reference's order."""

    def __init__(self, source: rng.RandomSource) -> None:
        self.source = source

    def rnd_many(self, moduli) -> list[int]:
        """Bulk draws, byte-stream-identical to sequential ``rnd`` calls
        (big.rnd_many)."""
        return big.rnd_many(moduli, self.source)


# ---------------------------------------------------------------------------
# the batched prover
# ---------------------------------------------------------------------------


def mesh_device(mesh, device, who: str) -> torch.device:
    """The device of an entry point built on ``mesh``: the mesh's, which
    needs a ``dp`` axis; a ``device`` the caller names as well must be the
    same."""
    if "dp" not in mesh.shape:
        raise ValueError(
            f"{who} shards the proof batch over a 'dp' mesh axis; got mesh axes "
            f"{tuple(mesh.shape)} - build the mesh with parallel.mesh.make_mesh() or make_mesh_2d()"
        )
    if device is not None:
        d = torch.device(device)
        if d.type != mesh.device.type or (d.index is not None and d != mesh.device):
            raise ValueError(f"{who}: device {d} is not the mesh's device {mesh.device}")
    return mesh.device


class BatchProver:
    """Proves batches of signatures against one parameter set on
    ``device`` (CUDA unless the caller names another; ``device="cpu"``
    runs the plain PyTorch versions).

    With a ``mesh`` (``parallel.mesh``) the instances are sharded over its
    ``dp`` axis and the GK ring over its ``ring`` axis when it has one;
    every rank calls :meth:`prove` with the same inputs and explicit tapes
    and gets the whole batch's proofs.  The batch must divide by the
    ``dp`` size."""

    # Largest sub-batch one prove pass handles: the per-instance comb4
    # tables take 110 KB each, the phase-B rows ~40 per instance.  Larger
    # batches chunk transparently: instances are independent, so chunked
    # proofs are byte-identical to unchunked.
    MAX_CHUNK = 256

    def __init__(self, params: SystemParametersList, device=None, mesh=None) -> None:
        if mesh is not None:
            device = mesh_device(mesh, device, "BatchProver")
        self.device = resolve_device(device)
        self.mesh = mesh
        self.params = params
        self.dev = device_params_for(params, self.device)
        self.tabs = self.dev.tabs()

    def warmup(self, n: int, e: int | Sequence[int] = (56, 64), ring: int = 4096) -> None:
        """Launch each kernel of a prove once, at the shapes a batch of
        ``n`` instances over a ring of ``ring`` keys gives, on fixed inputs
        (reference ``protocol/batch.py:612``, which compiles the phase
        programs).  Phase B runs once for each even-round capacity in
        ``e``, on the path a prove takes: without a mesh
        :func:`phase_b_flat` over K = n*e rows (quantized as a prove
        quantizes them), with one :func:`phase_b` on this rank's [n/dp, e]
        block.  The GK d-values and commitments run at the batch's ring.

        It draws no randomness (the inputs are a fixed pattern, never the
        ``utils.rng`` source), so a prove after it gives the same bytes as
        one without it.  The kernel library and ``libzkruntime.so`` load
        first; ``DeviceParams`` was built by the constructor.  On the CPU
        it runs the plain versions at the same shapes."""
        from ..runtime import native
        from .batch_gk import _gk_commit_device, _ring_len, _ring_sharded, gk_dvalues_device

        if self.device.type == "cuda":
            from .. import _build

            _build.load()
        native.available()
        mesh, device = self.mesh, self.device
        N = len(shard_batch(mesh, range(n)))  # this rank's instances
        fn, fo = P256_N, TOM_N

        def fixed(ctx, *shape):
            """[*shape, 9] canonical values: a fixed pattern of 257."""
            base = _pk_scalars(ctx, [(k + 1) * _WARM_MUL for k in range(257)], device)
            return base[torch.arange(int(np.prod(shape)), device=device) % 257].reshape(*shape, NLIMBS)

        pk = p256_ops.pack_points([p256.generator()] * N, device)
        pkx_v, pky_v, pky_r, txr = fixed(fo, N), fixed(fo, N), fixed(fo, N), fixed(fo, N, SECPARAM)
        a = phase_a(
            self.tabs, pk, *(fixed(fn, N) for _ in range(5)), pkx_v, fixed(fo, N), pky_v, pky_r,
            fixed(fn, N, SECPARAM), fixed(fn, N, SECPARAM), txr, fixed(fo, N, SECPARAM),
        )
        b_args = (self.tabs, a["T"], a["D"], a["TC"][:, :, 0], a["TC"][:, :, 1],
                  a["pkC"][:, 0], a["pkC"][:, 1], a["Tx_v"], pkx_v, pky_v, pky_r, txr)
        for ev in (e if isinstance(e, (tuple, list)) else (e,)):
            if mesh is None:
                K = _flat_rows(N * ev)
                srcid = torch.arange(K, device=device) % (N * SECPARAM)
                phase_b_flat(*b_args, fixed(fo, K, BK), fixed(fo, K, BK), srcid)
            else:
                eidx = (torch.arange(ev, device=device) % SECPARAM).expand(N, ev)
                phase_b(*b_args, fixed(fo, N, ev, BK), fixed(fo, N, ev, BK), eidx)
        RING, nbits = _ring_len(ring)
        if nbits:
            vals = [(k + 1) * _WARM_MUL % fo.p for k in range(RING)]
            eli = [[(i >> j) & 1 for j in range(nbits)] for i in range(n)]  # instance i proves key i % RING
            ai = [[(i * nbits + j + 1) * _WARM_MUL % fo.p for j in range(nbits)] for i in range(n)]
            vidx = [vals[i % RING] for i in range(n)]
            if _ring_sharded(mesh, RING):
                sharded_gk_dvalues(
                    mesh, torch.tensor(eli, dtype=torch.int32),
                    fo.pack([v for row in ai for v in row]).reshape(n, nbits, -1),
                    fo.pack(vals), fo.pack(vidx), dp_axis="dp",
                )
            else:
                gk_dvalues_device(shard_batch(mesh, eli), shard_batch(mesh, ai), vals,
                                  shard_batch(mesh, vidx), device)
            _gk_commit_device(self.tabs, fixed(fo, N * 4 * nbits), fixed(fo, N * 4 * nbits))
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    def prove(
        self,
        msg_hashes: Sequence[bytes],
        sig_bytes: Sequence[bytes],
        public_keys_raw: Sequence[bytes],
        whichs: Sequence[int],
        keys: list[int],
        tapes: Optional[Sequence[rng.RandomSource]] = None,
        timer=None,
    ) -> list[SignatureProofList]:
        """One proof an instance.  ``timer`` (or, where it is None, the
        timer ``utils.profiling.tracing`` installed) gets the stages and
        is installed for the call."""
        timer = profiling.current(timer)
        with profiling.tracing(timer):
            return self._prove_all(msg_hashes, sig_bytes, public_keys_raw, whichs, keys, tapes, timer)

    def _prove_all(self, msg_hashes, sig_bytes, public_keys_raw, whichs, keys, tapes, timer):
        N_all = len(msg_hashes)
        mesh = self.mesh
        if tapes is None:
            if mesh is not None:
                raise ValueError(
                    "under a mesh every rank must draw the same randomness: pass the tapes"
                )
            tapes = [rng.get_source() for _ in range(N_all)]
        if N_all > self.MAX_CHUNK:
            step = self.MAX_CHUNK
            if mesh is not None:  # dp-divisible chunks keep every shard even
                dp = mesh.shape["dp"]
                step = max(dp, step - step % dp)
            out: list[SignatureProofList] = []
            for lo in range(0, N_all, step):
                hi = min(lo + step, N_all)
                out.extend(self._prove_all(
                    msg_hashes[lo:hi], sig_bytes[lo:hi], public_keys_raw[lo:hi],
                    whichs[lo:hi], keys, tapes[lo:hi], timer,
                ))
            return out

        stage = stages(timer)
        params = self.params
        device = self.device
        N = len(msg_hashes)
        if params.sec_level != SECPARAM:
            raise ValueError("batched prover supports sec_level == 80")
        if N == 0:
            return []
        tapes = [_Tape(t) for t in tapes]
        n_ord = p256.order
        t_ord = tomEdwards256.order
        fn, fo = P256_N, TOM_N

        # ---- host: parse signatures (zkpAttestList.ts:113-136) ----
        pk_pts = [p256.deserialize_point(pk) for pk in public_keys_raw]
        pk_coords = [pt.to_affine() for pt in pk_pts]
        u1s, u2s, s1s, z1s = [], [], [], []
        for mh, sb in zip(msg_hashes, sig_bytes):
            z = _truncate_to_n(big.from_bytes(mh), n_ord)
            half = len(sb) // 2
            r = big.from_bytes(sb[:half])
            s = big.from_bytes(sb[half:])
            sinv = big.inv_mod(s, n_ord)
            rinv = big.inv_mod(r, n_ord)
            u1s.append(sinv * z % n_ord)
            u2s.append(sinv * r % n_ord)
            s1s.append(rinv * s % n_ord)
            z1s.append(rinv * z % n_ord)

        # ---- tape: phase-A randomness, reference order per instance:
        # com_r, pkx_r, pky_r, then 80x (alpha, r_rnd, txr, tyr) ----
        with stage("tape.phase_a"):
            com_r, pkx_r, pky_r = [], [], []
            alpha = [[0] * SECPARAM for _ in range(N)]
            r_rnd = [[0] * SECPARAM for _ in range(N)]
            txr = [[0] * SECPARAM for _ in range(N)]
            tyr = [[0] * SECPARAM for _ in range(N)]
            moduli_a = [n_ord, t_ord, t_ord] + [n_ord, n_ord, t_ord, t_ord] * SECPARAM
            for i, tape in enumerate(tapes):
                d = tape.rnd_many(moduli_a)
                com_r.append(d[0])
                pkx_r.append(d[1])
                pky_r.append(d[2])
                for j in range(SECPARAM):
                    alpha[i][j], r_rnd[i][j], txr[i][j], tyr[i][j] = d[3 + 4 * j : 7 + 4 * j]

        # the device phases take this rank's dp slice of the instances
        # (all of them without a mesh)
        def pack(ctx, vals):  # [N_l, 9]
            return _pk_scalars(ctx, shard_batch(mesh, vals), device)

        def pack2(ctx, rows):  # [N_l, 80, 9]
            rows = shard_batch(mesh, rows)
            return _pk_scalars(ctx, [v for row in rows for v in row], device).reshape(len(rows), SECPARAM, -1)

        with stage("phase_a.pack"):
            pkx_v = pack(fo, [c[0] for c in pk_coords])
            pky_v = pack(fo, [c[1] for c in pk_coords])
            pky_r_d = pack(fo, pky_r)
            txr_d = pack2(fo, txr)
            a_args = (
                self.tabs, p256_ops.pack_points(shard_batch(mesh, pk_pts), device),
                pack(fn, u1s), pack(fn, u2s), pack(fn, z1s), pack(fn, s1s), pack(fn, com_r),
                pkx_v, pack(fo, pkx_r), pky_v, pky_r_d,
                pack2(fn, alpha), pack2(fn, r_rnd), txr_d, pack2(fo, tyr),
            )
        with stage("phase_a.device"):
            a = phase_a(*a_args)
            # what the host reads, gathered over dp
            for k in ("small_aff", "pk_aff", "TA_aff", "TC_aff"):
                a[k] = tuple(gather(mesh, t) for t in a[k])

        # host point objects for hashing / assembly
        with stage("phase_a.unpack"):
            sm_x = _unp(p256_ops.f, a["small_aff"][0])  # [N*3]: R, Q, comS1
            sm_y = _unp(p256_ops.f, a["small_aff"][1])
            R_pts = [_nist_pt(sm_x[i * 3], sm_y[i * 3]) for i in range(N)]
            com_pts = [_nist_pt(sm_x[i * 3 + 2], sm_y[i * 3 + 2]) for i in range(N)]
            pk_x = _unp(tom_ops.f, a["pk_aff"][0])  # [N*2]: pkX, pkY
            pk_y = _unp(tom_ops.f, a["pk_aff"][1])
            pkX_pts = [_tom_pt(pk_x[i * 2], pk_y[i * 2]) for i in range(N)]
            pkY_pts = [_tom_pt(pk_x[i * 2 + 1], pk_y[i * 2 + 1]) for i in range(N)]
            a_x = _unp(p256_ops.f, a["TA_aff"][0][:, :, 1])  # [N*80]: A
            a_y = _unp(p256_ops.f, a["TA_aff"][1][:, :, 1])
            tc_x = _unp(tom_ops.f, a["TC_aff"][0])  # [N*80*2]: TxC, TyC
            tc_y = _unp(tom_ops.f, a["TC_aff"][1])

            def tc(i, j, s):
                k = (i * SECPARAM + j) * 2 + s
                return tc_x[k], tc_y[k]

            A_pts = [[_nist_pt(a_x[i * SECPARAM + j], a_y[i * SECPARAM + j])
                      for j in range(SECPARAM)] for i in range(N)]
            TxC_pts = [[_tom_pt(*tc(i, j, 0)) for j in range(SECPARAM)] for i in range(N)]
            TyC_pts = [[_tom_pt(*tc(i, j, 1)) for j in range(SECPARAM)] for i in range(N)]

        # ---- challenges (exp.ts:158-165), from the device's canonical
        # affine coordinates ----
        with stage("challenges.hash"):
            fbt, fbn = 33, 32  # Tom / P-256 coordinate widths
            pk_b = point_bytes(a["pk_aff"][0], a["pk_aff"][1], fbt).reshape(N, 2 * (1 + 2 * fbt))
            A_b = point_bytes(
                a["TA_aff"][0][:, :, 1], a["TA_aff"][1][:, :, 1], fbn
            ).reshape(N, SECPARAM, 1 + 2 * fbn)
            tc_b = point_bytes(a["TC_aff"][0], a["TC_aff"][1], fbt).reshape(
                N, SECPARAM, 2 * (1 + 2 * fbt)
            )
            rounds_b = np.concatenate([A_b, tc_b], axis=2).reshape(N, -1)
            challenges = challenge_rows([pk_b, rounds_b])

        # ---- tape: phase-B randomness (even bits only, reference order) --
        with stage("tape.phase_b"):
            zvals = [[0] * SECPARAM for _ in range(N)]
            names_b = ("t1x_r", "t1y_r", "c8_r", "c10_r", "c11_r", "c13_r")
            tape_b = {k: [[0] * SECPARAM for _ in range(N)] for k in names_b}

            def per_round(w):
                return [[[0] * w for _ in range(SECPARAM)] for _ in range(N)]

            kx, ky, kz, axr, ayr, azr, a41r = (per_round(4) for _ in range(7))
            keq, a1r, a2r = (per_round(2) for _ in range(3))
            even_mask = [[False] * SECPARAM for _ in range(N)]
            for i, tape in enumerate(tapes):
                ch = challenges[i]
                ev = []
                for j in range(SECPARAM):
                    zvals[i][j] = (alpha[i][j] - s1s[i]) % n_ord
                    if not (ch & 1):
                        even_mask[i][j] = True
                        ev.append(j)
                    ch >>= 1
                # 40 Tom-order draws per even round, in the sequential
                # order: the prove_exp even branch (exp.ts:195-200)
                # t1x_r/t1y_r, the provePointAdd commits C8/C10/C11/C13
                # (pointAdd.ts:138-143), then the sub-proofs pi8, pi10,
                # pi11, pix, pi13, piy (7 draws per mult proof, 3 per
                # equality proof)
                d = tape.rnd_many([t_ord] * (40 * len(ev)))
                p = 0
                for j in ev:
                    for nm in names_b:
                        tape_b[nm][i][j] = d[p]
                        p += 1
                    for sub in ("m0", "m1", "m2", "e0", "m3", "e1"):
                        if sub.startswith("m"):
                            jj = int(sub[1])
                            (
                                kx[i][j][jj], ky[i][j][jj], kz[i][j][jj],
                                axr[i][j][jj], ayr[i][j][jj], azr[i][j][jj],
                                a41r[i][j][jj],
                            ) = d[p : p + 7]
                            p += 7
                        else:
                            jj = int(sub[1])
                            keq[i][j][jj], a1r[i][j][jj], a2r[i][j][jj] = d[p : p + 3]
                            p += 3

        def commit_stack(pairs):
            """The [_SLOT]-ordered commit stack of the (i, j) rows:
            values and blindings [len(pairs), BK, 9]."""
            vals_rows, blind_rows = [], []
            for i, j in pairs:
                vals_rows += [0] * 6  # device fills t1x, t1y, i8, i10, i11, i13
                vals_rows += kx[i][j] + ky[i][j] + kz[i][j] + kz[i][j]
                vals_rows += keq[i][j] + keq[i][j]
                blind_rows += [tape_b[nm][i][j] for nm in names_b]
                blind_rows += axr[i][j] + ayr[i][j] + azr[i][j] + a41r[i][j]
                blind_rows += a1r[i][j] + a2r[i][j]
            return (_pk_scalars(fo, vals_rows, device).reshape(len(pairs), BK, -1),
                    _pk_scalars(fo, blind_rows, device).reshape(len(pairs), BK, -1))

        # Unsharded: one flat [K] row axis over all instances' even rounds,
        # K quantized to 64 (K_real <= 512) or 512; padding repeats the last
        # real row; an all-odd batch computes one placeholder row.  Under a
        # mesh: the [N, E] layout (E = the batch's largest even count
        # quantized to {48, 56, 64, 80}; an instance's padding repeats its
        # last even round), this rank's dp slice of it.
        flat = mesh is None
        with stage("phase_b.pack"):
            pairs = [(i, j) for i in range(N) for j in range(SECPARAM) if even_mask[i][j]]
            K_real = len(pairs)
            if flat:
                if not pairs:
                    pairs = [(0, 0)]
                K = _flat_rows(K_real)
                pairs_p = pairs + [pairs[-1]] * (K - len(pairs))
                srcid = torch.tensor([i * SECPARAM + j for i, j in pairs_p], dtype=torch.int64,
                                     device=device)
                com_vals, com_blinds = commit_stack(pairs_p)
            else:
                cnt = np.array([sum(row) for row in even_mask], np.int64)
                E = next(e for e in (48, 56, 64, SECPARAM) if cnt.max() <= e)
                eidx = np.zeros((N, E), np.int64)
                for i in range(N):
                    ev = [j for j in range(SECPARAM) if even_mask[i][j]]
                    eidx[i, : len(ev)] = ev
                    eidx[i, len(ev) :] = ev[-1] if ev else 0
                mine = shard_batch(mesh, range(N))
                com_vals, com_blinds = commit_stack([(i, int(j)) for i in mine for j in eidx[i]])
                com_vals = com_vals.reshape(len(mine), E, BK, -1)
                com_blinds = com_blinds.reshape(len(mine), E, BK, -1)

        with stage("phase_b.device"):
            b_args = (
                self.tabs, a["T"], a["D"], a["TC"][:, :, 0], a["TC"][:, :, 1],
                a["pkC"][:, 0], a["pkC"][:, 1], a["Tx_v"],
                pkx_v, pky_v, pky_r_d, txr_d, com_vals, com_blinds,
            )
            if flat:
                b = phase_b_flat(*b_args, srcid)
            else:
                b = phase_b(*b_args, torch.from_numpy(eidx[mine.start : mine.stop]).to(device))

        # ---- batched GK membership (tape order per instance: after the
        # exp draws, zkpAttestList.ts:141-142); launched while phase B
        # runs on the card ----
        from .batch_gk import batch_prove_membership

        tsc = tomEdwards256.new_scalar
        gk_proofs = batch_prove_membership(
            params.proof_group,
            [Commitment(pkX_pts[i], tsc(pkx_r[i])) for i in range(N)],
            whichs, keys, [t.source for t in tapes], dev=self.dev, timer=timer, mesh=mesh,
        )

        with stage("phase_b.unpack"):
            # valid rows, in (i, ascending j) order: the first K_real of the
            # flat layout, the first cnt[i] of each instance's [N, E] row;
            # ``pos`` maps (i, j) to its row
            emask = np.asarray(even_mask)  # [N, 80]
            pos = np.full((N, SECPARAM), -1, np.int64)
            pos[emask] = np.arange(int(emask.sum()))
            if flat:
                ints_v = b["ints"][:K_real]
                ex, ey = (t[:K_real].cpu() for t in b["tom_aff"])  # [K_real, NSLOT, 9]
            else:
                sel = torch.from_numpy(np.arange(E)[None, :] < cnt[:, None])  # [N, E]
                ints_v = gather(mesh, b["ints"]).cpu()[sel]
                ex, ey = (gather(mesh, t).cpu()[sel] for t in b["tom_aff"])
            ints = _unp(fo, ints_v)  # [K_real*7]: i7..i13 per row
            tom_x = _unp(tom_ops.f, ex[:, : BK + 8])
            tom_y = _unp(tom_ops.f, ey[:, : BK + 8])

        # ---- sub-proof Fiat-Shamir (pointAdd.ts:116, mult.ts:116,
        # equality.ts:66): all six challenges of every even row ----
        with stage("subproof.hash"):
            pb = point_bytes(ex, ey, 33).reshape(K_real, NSLOT, 67)
            g_b = np.broadcast_to(
                np.frombuffer(params.proof_group.g.to_bytes(), np.uint8), (K_real, 67)
            )
            S = _SLOT

            def sl(name, off=0):
                return pb[:, S[name] + off]

            def mult_msg(cx, cy, cz, jj):
                return [cx, cy, cz] + [sl(nm, jj) for nm in ("C4", "Ax", "Ay", "Az", "A41", "A42")]

            c_pi8 = challenge_rows(mult_msg(sl("C7"), sl("C8"), g_b, 0))
            c_pi10 = challenge_rows(mult_msg(sl("C8"), sl("C9"), sl("C10"), 1))
            c_pi11 = challenge_rows(mult_msg(sl("C10"), sl("C10"), sl("C11"), 2))
            c_pix = challenge_rows([sl("C11"), sl("CIX"), sl("A1", 0), sl("A2", 0)])
            c_pi13 = challenge_rows(mult_msg(sl("C10"), sl("C12"), sl("C13"), 3))
            c_piy = challenge_rows([sl("C13"), sl("CIY"), sl("A1", 1), sl("A2", 1)])

        # ---- assemble the exp proofs per instance and round ----
        with stage("assembly"):
            proofs = []
            for i in range(N):
                exp_proofs = []
                for j in range(SECPARAM):
                    A_p, Tx_p, Ty_p = A_pts[i][j], TxC_pts[i][j], TyC_pts[i][j]
                    if not even_mask[i][j]:
                        exp_proofs.append(ExpProof(
                            A_p, Tx_p, Ty_p,
                            alpha=p256.new_scalar(alpha[i][j]),
                            beta1=p256.new_scalar(r_rnd[i][j]),
                            beta2=tsc(txr[i][j]),
                            beta3=tsc(tyr[i][j]),
                        ))
                        continue
                    k = pos[i, j]  # even-round row
                    exp_proofs.append(self._even_round(
                        k, tom_x, tom_y, ints[7 * k : 7 * k + 7],
                        (c_pi8[k], c_pi10[k], c_pi11[k], c_pix[k], c_pi13[k], c_piy[k]),
                        {nm: tape_b[nm][i][j] for nm in names_b},
                        (pkx_r[i], pky_r[i], txr[i][j], tyr[i][j]),
                        (kx[i][j], ky[i][j], kz[i][j], axr[i][j], ayr[i][j], azr[i][j],
                         a41r[i][j], keq[i][j], a1r[i][j], a2r[i][j]),
                        A_p, Tx_p, Ty_p,
                        z=zvals[i][j], z2=(r_rnd[i][j] - com_r[i]) % n_ord,
                    ))
                proofs.append(SignatureProofList(
                    R_pts[i], com_pts[i], pkX_pts[i], pkY_pts[i], exp_proofs, gk_proofs[i],
                ))
        return proofs

    @staticmethod
    def _even_round(k, tom_x, tom_y, ints, chals, tb, blinds, nonces, A_p, Tx_p, Ty_p, z, z2):
        """The ExpProof of an even-bit round from its phase-B row ``k``:
        point-add sub-proof assembly in integer arithmetic mod the Tom-256
        order (pointAdd.ts:116-259 responses)."""
        t_ord = tomEdwards256.order
        tsc = tomEdwards256.new_scalar
        i7, i8, i9, i10, i11, i12, i13 = ints
        c8, c10, c11, cx, c13, cy = chals
        qx_r, qy_r, rx_r, ry_r = blinds
        kx_r, ky_r, kz_r, axr_r, ayr_r, azr_r, a41r_r, keq_r, a1r_r, a2r_r = nonces
        base_k = k * (BK + 8)

        def pt_at(slot):
            return _tom_pt(tom_x[base_k + slot], tom_y[base_k + slot])

        # blinding scalars of the commitments and their homomorphic
        # combinations (pointAdd.ts:124-138)
        px_r, py_r = tb["t1x_r"], tb["t1y_r"]
        C7r = (qx_r - px_r) % t_ord
        C9r = (qy_r - py_r) % t_ord
        C12r = (px_r - rx_r) % t_ord
        cintXr = (rx_r + px_r + qx_r) % t_ord
        cintYr = (ry_r + py_r) % t_ord
        C8r, C10r, C11r, C13r = tb["c8_r"], tb["c10_r"], tb["c11_r"], tb["c13_r"]
        S = _SLOT

        def mk_mult(jj, c, x, y, zv, rx, ry, rz):
            r4 = ry * x  # Cy.r * x (mult.ts:105 auxiliary blinding)
            return MultProof(
                pt_at(S["C4"] + jj), pt_at(S["Ax"] + jj), pt_at(S["Ay"] + jj),
                pt_at(S["Az"] + jj), pt_at(S["A41"] + jj), pt_at(S["A42"] + jj),
                tsc(kx_r[jj] - c * x),
                tsc(ky_r[jj] - c * y),
                tsc(kz_r[jj] - c * zv),
                tsc(axr_r[jj] - c * rx),
                tsc(ayr_r[jj] - c * ry),
                tsc(azr_r[jj] - c * rz),
                tsc(a41r_r[jj] - c * r4),
            )

        def mk_eq(jj, c, x, r1, r2):
            return EqualityProof(
                pt_at(S["A1"] + jj), pt_at(S["A2"] + jj),
                tsc(keq_r[jj] - c * x),
                tsc(a1r_r[jj] - c * r1),
                tsc(a2r_r[jj] - c * r2),
            )

        pa = PointAddProof(
            pt_at(S["C8"]), pt_at(S["C10"]), pt_at(S["C11"]), pt_at(S["C13"]),
            mk_mult(0, c8, i7, i8, 1, C7r, C8r, 0),
            mk_mult(1, c10, i8, i9, i10, C8r, C9r, C10r),
            mk_mult(2, c11, i10, i10, i11, C10r, C10r, C11r),
            mk_mult(3, c13, i10, i12, i13, C10r, C12r, C13r),
            mk_eq(0, cx, i11, C11r, cintXr),
            mk_eq(1, cy, i13, C13r, cintYr),
        )
        return ExpProof(
            A_p, Tx_p, Ty_p,
            z=p256.new_scalar(z), z2=p256.new_scalar(z2), proof=pa,
            r1=tsc(px_r), r2=tsc(py_r),
        )


def batched_prove_signature_list(
    params: SystemParametersList,
    msg_hashes: Sequence[bytes],
    sig_bytes: Sequence[bytes],
    public_keys_raw: Sequence[bytes],
    whichs: Sequence[int],
    keys: list[int],
    tapes: Optional[Sequence[rng.RandomSource]] = None,
    device=None,
    mesh=None,
) -> list[SignatureProofList]:
    return BatchProver(params, device, mesh).prove(
        msg_hashes, sig_bytes, public_keys_raw, whichs, keys, tapes
    )
