"""Batched ZKAttest verifier: the port of
``zkecdsa_tpu/protocol/batch_verify.py`` (reference src/zkpAttestList.ts:
147-184 and src/exp/exp.ts:233-349 run per proof; here one device pipeline
verifies a whole batch).

Phase structure:

* host: structural checks, Fiat-Shamir challenge recomputation, the random
  20-of-80 round sample (exp.ts:95-109), GK challenge hashes;
* device phase V (:func:`vphase`): Q = z1*G and the sampled rounds'
  T = m*R as T = 1 rows of the Straus kernel, T1 = T + Q, one affine pass,
  and the bit-0 T1x/T1y coordinate commitments on the comb kernel;
* device GK recombination (ring_fold, one kernel launch);
* host: relation assembly (exact reference algebra) into one MSM row per
  (proof, curve), as flat integers over the batch (``batch_assemble``);
* device MSM: one combined random-linear-combination check per curve on
  the Straus kernel, with per-row checks to attribute a failure.

Semantics match ``verify_signature_list`` per instance, with one
difference: structural errors that make the scalar verifier *raise*
(missing optional ExpProof fields, points at infinity, secparam >
len(expProof)) mark just that instance False here - a batch must not die
on one malformed proof.

With a mesh (``parallel.mesh``) every rank runs the host stages on the
whole batch and the device stages on its ``dp`` slice (phase V, the GK
recombination - ring-sharded too when the mesh has a ``ring`` axis - and
the MSM rows or sub-rows); device outputs are gathered over ``dp``.  The
verifier's own random draws (the round sample, the combined check's r_i)
must then agree across ranks: each verify runs on a DRBG seeded with 32
bytes from the mesh's first rank.
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch

from ..bignum import big
from ..curves.group import Group, Point, hash_points
from ..curves.instances import p256
from ..exp.exp import generate_indices, padded_bits
from ..ops.curve_ops import (
    byte_digits,
    comb_mixed,
    ec_add,
    nibble_digits,
    p256_ops,
    straus_msm,
    straus_table_bytes,
    sum_reduce,
    to_affine,
    tom_ops,
    war_ops,
)
from ..ops.field import NLIMBS, TOM_N, bytes_le
from ..ops.msm_bucket import bucket_bytes, bucket_fold, bucket_sums, pick_window, window_digits
from ..parallel.mesh import from_first_rank, gather, shard_batch, sharded_gk_recombine
from ..proofGK.gk import _pad, gk_statement_bind
from ..runtime import native
from ..utils import profiling, rng
from ..utils.config import get_config
from ..utils.profiling import stages
from ..zkp_attest_list import SignatureProofList, SystemParametersList, _truncate_to_n
from .batch import _pk_scalars, _unp, device_params_for, mesh_device, resolve_device
from .batch_assemble import assemble_rows
from .batch_gk import _ring_len, _ring_sharded, gk_recombine_device

__all__ = ["BatchVerifier", "batch_verify_signature_list", "vphase"]

_OPS = {"p256": p256_ops, "tomEdwards256": tom_ops, "war256": war_ops}

fw = p256_ops.f
fo = TOM_N


def _verify_rounds() -> int:
    """Top-level verifier spot-check count (zkpAttestList.ts:177 hardcodes
    20; Config.verify_rounds / ZKECDSA_VERIFY_ROUNDS)."""
    return get_config().verify_rounds


def _u8(a: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.uint8)).to(device)


def vphase(tabs, R, z1d, md, bits, rb8):
    """R [N, 3, 9] P-256 points; z1d [N, 64] nibbles; md [N, S, 64]
    nibbles (alpha or z per sampled round); bits [N, S] bool; rb8
    [N, S, 2, 32] LSB-first bytes of the Tom-order blindings.  Everything
    the exp verifier needs from the device in one pass; every output is
    canonical limbs."""
    N, S = md.shape[0], md.shape[1]
    # Q = z1*G and T = m*R as S+1 single-term Straus rows per proof (row 0
    # takes G, rows 1..S the proof's R)
    G = tabs["G"][1]
    base = torch.cat(
        [G.expand(N, 1, 3, -1), R[:, None].expand(N, S, 3, -1)], dim=1
    )
    dig = torch.cat([z1d[:, None], md], dim=1)
    qt = straus_msm(
        p256_ops, base.reshape(N * (S + 1), 1, 3, -1), dig.reshape(N * (S + 1), 1, -1)
    ).reshape(N, S + 1, 3, -1)
    Q, T0 = qt[:, 0], qt[:, 1:]
    T1 = ec_add(p256_ops, T0, Q[:, None])  # bit-0: T1 = z*R + Q
    Tc = p256_ops.select(bits, T0, T1)  # coordinate source
    st = torch.stack([T0, Tc], dim=-3)  # [N, S, 2, 3, 9]
    x, y, inf = to_affine(p256_ops, st)
    sx, sy = x[..., 1, :], y[..., 1, :]
    # canonical limbs are their own byte digits: the coordinates commit as
    # Tom-order scalars (the Tom-256 order is the P-256 base prime)
    d8 = torch.cat([bytes_le(torch.stack([sx, sy], dim=-2)), rb8], dim=-1)
    com = comb_mixed(tabs["gh_t8"], d8)
    cx, cy, _ = to_affine(tom_ops, com)  # [N, S, 2, 9]
    return {
        "T0_aff": (x[..., 0, :], y[..., 0, :], inf[..., 0]),
        "coord": (sx, sy, inf[..., 1]),
        "com_aff": (cx, cy),
    }


# Scratch for one MSM dispatch: the Straus window tables (R*T*16 points)
# or the bucket sums (R*D*2^w points).  The H100 has 80 GB; 8 GiB leaves
# most of it to the rest of the process (the v5e reference budgeted 2 GiB
# of its 16 GiB).
MSM_TABLE_BYTES = 8 << 30


def _msm_rows(ops, arr: torch.Tensor, digits: torch.Tensor) -> list[torch.Tensor]:
    """straus_msm over row blocks that keep the window tables in budget."""
    R, T = arr.shape[0], arr.shape[1]
    step = max(1, min(R, MSM_TABLE_BYTES // max(1, straus_table_bytes(ops, 1, T))))
    return [straus_msm(ops, arr[i : i + step], digits[i : i + step]) for i in range(0, R, step)]


def _bucket_rows(ops, arr: torch.Tensor, digits: torch.Tensor, window: int) -> list[torch.Tensor]:
    """The bucket kernels over row blocks that keep the bucket sums in
    budget."""
    R = arr.shape[0]
    step = max(1, min(R, MSM_TABLE_BYTES // bucket_bytes(ops, 1, window)))
    return [
        bucket_fold(ops, bucket_sums(ops, arr[i : i + step], digits[i : i + step], window), window)
        for i in range(0, R, step)
    ]


def _batched_msm_identity(
    group: Group,
    rows: list[tuple[list[Point], list[int]]],
    device,
    t_static: int | None = None,
    timer=None,
    mesh=None,
) -> np.ndarray:
    """Is sum s_i P_i the identity, per row?  Rows are padded with
    (identity, 0) to a shared length: the challenge-independent worst-case
    bound ``t_static`` (see :meth:`BatchVerifier._t_static`) when the
    batch comes near it, else a power of two; rows beyond the bound (only
    past the ~P99.99 challenge tail) are checked in a dispatch of their
    own.

    Backend: the Straus kernel, or the bucket (Pippenger) kernels when T
    reaches ``Config.pippenger_min_t`` (0, the default, never): they keep
    no [T, 16] window table, only the [D, 2^w] bucket sums of a row.

    With a ``mesh`` each rank checks its dp slice of the rows (in
    memory-budget chunks) and the verdicts are gathered."""
    ops = _OPS[group.name]
    N = len(rows)
    if N == 0:
        return np.zeros(0, dtype=bool)
    tmax = max((len(p) for p, _ in rows), default=1)
    if t_static is not None and tmax > t_static // 2:
        T = t_static
    else:
        T = 1 << max(5, (tmax - 1).bit_length())
    if tmax > T:  # t_static overflow: split off the oversized rows
        over = [i for i, (p, _) in enumerate(rows) if len(p) > T]
        fit = [(p, s) if len(p) <= T else ([], []) for (p, s) in rows]
        ok = _batched_msm_identity(group, fit, device, t_static=t_static, mesh=mesh)
        ok_over = _batched_msm_identity(group, [rows[i] for i in over], device)
        for k, i in enumerate(over):
            ok[i] = ok_over[k]
        return ok
    stage = stages(timer)
    with stage("msm.pack_host"):
        real: list[Point] = []
        scs: list[int] = []
        for p, s in rows:
            real.extend(p)
            scs.extend(s)
            scs.extend([0] * (T - len(s)))
        arr = ops.pack_points([group.identity()]).expand(N * T, ops.NCOORD, -1).clone()
        if real:
            pos = torch.from_numpy(np.concatenate(
                [np.arange(len(p)) + i * T for i, (p, _) in enumerate(rows)]
            ).astype(np.int64))
            arr[pos] = ops.pack_points(real)
    with stage("msm.upload"):
        arr = shard_batch(mesh, arr.reshape(N, T, ops.NCOORD, -1)).to(device)
    min_t = get_config().pippenger_min_t
    window = pick_window(T) if min_t and T >= min_t else None
    with stage("msm.digits"):
        if window is None:
            digits = _u8(shard_batch(mesh, nibble_digits(scs).reshape(N, T, 64)), device)
        else:
            srows = [scs[i * T : (i + 1) * T] for i in range(N)]
            digits = torch.from_numpy(shard_batch(mesh, window_digits(srows, T, window))).to(device)
    with stage("msm.device"):
        sums = _msm_rows(ops, arr, digits) if window is None else _bucket_rows(ops, arr, digits, window)
        return gather(mesh, torch.cat([ops.is_identity(s) for s in sums])).cpu().numpy()


_COMB_W = 8192  # combined-MSM sub-row width (see _combined_msm_identity)


def _combined_msm_identity(
    group: Group,
    rows: list[tuple[list[Point], list[int]]],
    device,
    t_static: int | None = None,
    timer=None,
    mesh=None,
) -> np.ndarray:
    """Hierarchical batch identity check.

    Every row already sums to the identity for a valid proof, so one more
    random-linear-combination level collapses the whole batch: scale row
    i's scalars by a fresh verifier-internal random r_i, concatenate all
    pairs into identity-padded sub-rows of _COMB_W terms, sum them on the
    device and identity-check the total.  If any row were non-identity the
    combined sum survives with probability 1 - 1/order (the argument of
    Relation.drain, multimult.ts:147-174).  Only when the combined check
    fails do the per-row checks run, to say which rows failed: that
    attribution pass is the stage ``msm.attribution``, which counts
    ``msm.attribution_rows`` and ``msm.rows_failed``.  Batches too small
    to fill four sub-rows take the per-row path directly.

    With a ``mesh`` the sub-rows (a multiple of lcm(4, dp)) are split over
    ``dp``; each rank sums its share, and the partial points are gathered
    and folded with ``tree_sum``, so every rank reaches the same verdict.
    The r_i agree across ranks because the verify runs on a DRBG the ranks
    share (see :class:`BatchVerifier`)."""
    stage = stages(timer)
    N = len(rows)
    if N == 0:
        return np.zeros(0, dtype=bool)
    ops = _OPS[group.name]
    order = group.order
    total = sum(len(p) for p, _ in rows)
    if total < 4 * _COMB_W:
        return _batched_msm_identity(group, rows, device, t_static=t_static, timer=timer, mesh=mesh)
    q = math.lcm(4, mesh.shape["dp"]) if mesh is not None else 4
    with stage("msm.combine_host"):
        pts: list[Point] = []
        scs: list[int] = []
        for p, s in rows:
            r = big.rnd(order)
            pts.extend(p)
            scs.extend(r * v % order for v in s)
        k = q * -(-total // (q * _COMB_W))  # sub-rows, a multiple of q
        pad = k * _COMB_W - total
        arr = torch.cat([
            ops.pack_points(pts),
            ops.pack_points([group.identity()]).expand(pad, ops.NCOORD, -1),
        ])
        scs.extend([0] * pad)
    with stage("msm.upload"):
        arr = shard_batch(mesh, arr.reshape(k, _COMB_W, ops.NCOORD, -1)).to(device)
    with stage("msm.digits"):
        digits = _u8(shard_batch(mesh, nibble_digits(scs).reshape(k, _COMB_W, 64)), device)
    with stage("msm.device"):
        parts = torch.cat(_msm_rows(ops, arr, digits))  # [k/dp, C, 9]
        local = sum_reduce(ops, parts, axis=0)
        all_ok = bool(ops.is_identity(sum_reduce(ops, gather(mesh, local[None]), axis=0)))
    if all_ok:
        return np.ones(N, dtype=bool)
    # attribution pass: some row failed - per-row checks
    with stage("msm.attribution"):
        ok = _batched_msm_identity(group, rows, device, t_static=t_static, timer=timer, mesh=mesh)
        profiling.count("msm.attribution_rows", N)
        profiling.count("msm.rows_failed", int(N - ok.sum()))
    return ok


class BatchVerifier:
    """Verifies batches of ``SignatureProofList`` against one parameter set
    and one ring, on ``device`` (CUDA unless the caller names another;
    ``device="cpu"`` runs the plain PyTorch versions).

    With a ``mesh`` (``parallel.mesh``) the proofs are sharded over its
    ``dp`` axis (the batch must divide by its size) and the GK ring over
    its ``ring`` axis when it has one; every rank calls :meth:`verify`
    with the same inputs and gets every verdict.  Each verify then draws
    its randomness from a DRBG seeded with 32 bytes from the mesh's first
    rank, so that the ranks sample the same rounds."""

    # Largest sub-batch one verify pass handles; beyond it the batch
    # chunks transparently (proofs are independent).
    MAX_CHUNK = 256

    def __init__(self, params: SystemParametersList, device=None, mesh=None) -> None:
        if mesh is not None:
            device = mesh_device(mesh, device, "BatchVerifier")
        self.device = resolve_device(device)
        self.mesh = mesh
        self.params = params
        self.dev = device_params_for(params, self.device)
        self.tabs = self.dev.tabs()

    def verify(
        self,
        msg_hashes: Sequence[bytes],
        keys: list[int],
        proofs: Sequence[SignatureProofList],
        timer=None,
    ) -> list[bool]:
        """The verdict of each proof.  ``timer`` (or, where it is None,
        the timer ``utils.profiling.tracing`` installed) gets the stages
        and is installed for the call."""
        timer = profiling.current(timer)
        with profiling.tracing(timer):
            return self._verify_all(msg_hashes, keys, proofs, timer)

    def _verify_all(self, msg_hashes, keys, proofs, timer) -> list[bool]:
        N_all = len(proofs)
        mesh = self.mesh
        if N_all > self.MAX_CHUNK:
            step = self.MAX_CHUNK
            if mesh is not None:  # dp-divisible chunks keep every shard even
                dp = mesh.shape["dp"]
                step = max(dp, step - step % dp)
            out: list[bool] = []
            for lo in range(0, N_all, step):
                hi = min(lo + step, N_all)
                out.extend(self._verify_all(msg_hashes[lo:hi], keys, proofs[lo:hi], timer))
            return out
        if mesh is None:
            return self._verify(msg_hashes, keys, proofs, timer)
        seed = from_first_rank(mesh, torch.tensor(list(rng.random_bytes(32)), dtype=torch.uint8))
        with rng.scoped(rng.DeterministicSource(bytes(seed.cpu().tolist()))):
            return self._verify(msg_hashes, keys, proofs, timer)

    def _verify(self, msg_hashes, keys, proofs, timer) -> list[bool]:
        mesh = self.mesh

        def mine(x):  # this rank's dp slice (everything without a mesh)
            return shard_batch(mesh, x)

        stage = stages(timer)
        params = self.params
        device = self.device
        N = len(proofs)
        if N == 0:
            return []
        S = _verify_rounds()
        n_ord = p256.order
        pg = params.proof_group

        ok = [True] * N
        # ---- host: parse + challenges + round sampling ----
        with stage("verify.host_prep"):
            # all exp challenges in one hash batch (the messages are
            # serialized proof points; exp.ts:260 recomputation)
            msgs = []
            for proof in proofs:
                try:
                    parts = [proof.keyXcom.to_bytes(), proof.keyYcom.to_bytes()]
                    for p in proof.expProof:
                        parts += [p.A.to_bytes(), p.Tx.to_bytes(), p.Ty.to_bytes()]
                    msgs.append(b"".join(parts))
                except Exception:
                    msgs.append(b"")
            digests = native.sha256_batch(msgs)
            z1s = [0] * N
            m_sc = [[0] * S for _ in range(N)]
            rb = [[(0, 0)] * S for _ in range(N)]
            sel_idx = [[0] * S for _ in range(N)]
            sel_bit = [[True] * S for _ in range(N)]
            for i, proof in enumerate(proofs):
                pi = proof.expProof
                coordR = proof.R.to_affine()
                if coordR is None or S > len(pi):
                    ok[i] = False
                    continue
                z = _truncate_to_n(big.from_bytes(msg_hashes[i]), n_ord)
                rinv = big.inv_mod(coordR[0], n_ord)
                z1s[i] = rinv * z % n_ord
                challenge = big.from_bytes(digests[i][:10])
                indices = generate_indices(S, len(pi))
                bits = padded_bits(challenge, len(pi))
                for j in range(S):
                    r_i = indices[j]
                    rp = pi[r_i]
                    sel_idx[i][j] = r_i
                    sel_bit[i][j] = bits[r_i]
                    if bits[r_i]:
                        if not (rp.alpha and rp.beta1 and rp.beta2 and rp.beta3):
                            ok[i] = False
                            break
                        m_sc[i][j] = rp.alpha.k
                    else:
                        if not (rp.z and rp.z2 and rp.proof and rp.r1 and rp.r2):
                            ok[i] = False
                            break
                        m_sc[i][j] = rp.z.k
                        rb[i][j] = (rp.r1.k, rp.r2.k)

        # ---- device phase V, on this rank's dp slice ----
        with stage("verify.device"):
            v = vphase(
                self.tabs,
                p256_ops.pack_points([p.R for p in mine(proofs)], device),
                _u8(mine(nibble_digits(z1s)), device),
                _u8(mine(nibble_digits([m for row in m_sc for m in row]).reshape(N, S, 64)), device),
                torch.tensor(mine(sel_bit), dtype=torch.bool, device=device),
                _u8(
                    mine(byte_digits([x for row in rb for pair in row for x in pair]).reshape(N, S, 2, 32)),
                    device,
                ),
            )
            v = {k: tuple(gather(mesh, t) for t in ts) for k, ts in v.items()}

        with stage("verify.unpack"):
            # the sampled round's affine coords feed relTx/relTy only on
            # challenge-bit-1 rounds, the T1x/T1y commitments only bit-0
            # rounds - unpack each only where used
            bmask = np.asarray(sel_bit)  # [N, S]
            bm = torch.from_numpy(bmask).to(device)
            pos1 = np.full((N, S), -1, np.int64)
            pos1[bmask] = np.arange(int(bmask.sum()))
            pos0 = np.full((N, S), -1, np.int64)
            pos0[~bmask] = np.arange(int((~bmask).sum()))
            t0x = _unp(fw, v["T0_aff"][0])  # [N*S]
            t0y = _unp(fw, v["T0_aff"][1])
            t0inf = v["T0_aff"][2].cpu().numpy().reshape(N, S)
            sxs = _unp(fo, v["coord"][0][bm])
            sys_ = _unp(fo, v["coord"][1][bm])
            cinf = v["coord"][2].cpu().numpy().reshape(N, S)
            comx = _unp(tom_ops.f, v["com_aff"][0][~bm])
            comy = _unp(tom_ops.f, v["com_aff"][1][~bm])

        # ---- GK: device ring recombination for all proofs ----
        with stage("verify.gk_recombine"):
            values_s = _pad(keys, pg.c)
            RING, n = _ring_len(len(keys))
            gk_x = [0] * N
            for i, proof in enumerate(proofs):
                mp = proof.membershipProof
                if not ok[i]:
                    continue
                if any(
                    len(arr) != n
                    for arr in (mp.cl, mp.ca, mp.cb, mp.cd, mp.f, mp.za, mp.zb)
                ):
                    ok[i] = False
                    continue
                gk_x[i] = gk_statement_bind(
                    hash_points(mp.cl + mp.ca + mp.cb + mp.cd),
                    proof.keyXcom, values_s,
                )
            t_ord = pg.c.order
            f_ints = [
                [proofs[i].membershipProof.f[j].k if ok[i] else 0 for j in range(n)]
                for i in range(N)
            ]
            xf_ints = [
                [(gk_x[i] - f_ints[i][j]) % t_ord for j in range(n)]
                for i in range(N)
            ]
            # (N, n, NLIMBS), not -1: a ring of one key has n = 0 index bits
            f_t = _pk_scalars(fo, [x for row in f_ints for x in row], device).reshape(N, n, NLIMBS)
            xf_t = _pk_scalars(fo, [x for row in xf_ints for x in row], device).reshape(N, n, NLIMBS)
            vals_t = _pk_scalars(fo, [v_.k for v_ in values_s], device)
            if _ring_sharded(mesh, RING) and n > 0:
                tot_dev = gather(mesh, sharded_gk_recombine(mesh, f_t, xf_t, vals_t, dp_axis="dp"))
            else:
                tot_dev = gather(mesh, gk_recombine_device(mine(f_t), mine(xf_t), vals_t))
            totals = _unp(fo, tot_dev)

        # ---- host: the MSM rows, as flat integers over the batch ----
        with stage("verify.assemble"):
            rows_w, rows_n = assemble_rows(
                params, proofs, ok, n, gk_x, totals, sel_idx, sel_bit,
                t0x, t0y, t0inf, sxs, sys_, cinf, comx, comy, pos0, pos1,
            )

        # ---- device MSMs (one combined check per curve); stages msm.* ----
        t_w, t_n = self._t_static(n, S)
        ok_w = _combined_msm_identity(pg.c, rows_w, device, t_static=t_w, timer=timer, mesh=mesh)
        ok_n = _combined_msm_identity(p256, rows_n, device, t_static=t_n, timer=timer, mesh=mesh)
        return [bool(ok[i] and ok_w[i] and ok_n[i]) for i in range(N)]

    @staticmethod
    def _t_static(n: int, S: int) -> tuple[int, int]:
        """Challenge-independent MSM term bounds per proof row, from the
        aggregation structure.

        Proof-group row (after MultiMult's identity merging): g + h +
        keyXcom + GK (cl/ca/cb/cd per index bit = 4n) + per sampled exp
        round either 2 (bit-1: Tx-, Ty-) or 37 (bit-0: the point-add
        aggregation's distinct commitment/nonce points, pointAdd.ts:
        199-259).  The bound covers up to S-1 bit-0 rounds (the all-zeros
        challenge tail, ~2^-S per row, overflows to the fallback split).
        NIST row: R + h_n + comS1 + 2 per round (T/T1 + A-)."""
        t_w = 3 + 4 * n + 2 * S + 35 * max(S - 1, 0)
        t_n = 3 + 2 * S
        rnd8 = lambda v: -(-v // 8) * 8  # noqa: E731
        return rnd8(t_w), rnd8(t_n)


def batch_verify_signature_list(
    params: SystemParametersList,
    msg_hashes: Sequence[bytes],
    keys: list[int],
    proofs: Sequence[SignatureProofList],
    device=None,
    mesh=None,
) -> list[bool]:
    return BatchVerifier(params, device, mesh).verify(msg_hashes, keys, proofs)
