#!/usr/bin/env python3
"""Start-up proof of the PyTorch/CUDA port (``zkecdsa_tpu_torch``) on one
NVIDIA GPU.

Run from the repository root, on a machine with a card and ``nvcc``:

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

1. print the card's name and power limit (``nvidia-smi``);
2. build the CUDA kernels from ``zkecdsa_tpu_torch/csrc`` (nvcc, sm_90a)
   and, beside them, the host runtime ``libzkruntime.so`` from
   ``zkecdsa_tpu_torch/runtime/native.cpp`` (g++), which must run
   (``native.available()``); hold its ``sha256_rows``/``sha256_batch``
   against ``hashlib`` on the prover's shapes (the DRBG's [blocks, 40]
   counter rows of one instance's tapes, recorded; the challenge and
   sub-proof rows) and a verify's message list, timed beside ``hashlib``;
3. hold every kernel against its plain PyTorch version on the card, on the
   same inputs and exactly (integers: tolerance 0), at every shape the
   prover gives it and at the verifier's, and time both with CUDA events
   (``straus_msm`` at every shape of one verify and of path B, each with
   its schedule-independent bound and its launches per path; ``shamir``'s
   two calls apart; ``window_table`` beside the 15 ``ec_add`` launches a
   table it replaced, and phase A's one [N, 2] ``ec_add`` call beside
   the two [N] launches it merged; ``ec_add`` (a team of four lanes a
   pair) at every call of a prove and a verify beside the one-thread
   kernel it replaced (``tools/torch_ec_add_sweep.py``, whose library is
   built beside the kernels too); ``tree_sum`` at the
   verifier's two trees beside the ``ec_add`` level loops it replaced;
   ``chord`` (T1's affine pass and the chord pass in one launch) beside
   the pair it replaced (``to_affine`` [K] and the old chord kernel, from
   ``tools/torch_chord_probe.py``, whose library is built beside the
   kernels), with its zero rows against Python integers; ``comb_mixed``
   at its four calls, ``mul_comb4`` at its one and ``comb_weier`` at its
   one ([N, 81]) and
   at the two calls it merged, each under ``comb_plan``'s geometry and
   under the other one;
   ``comb4_entries`` in Montgomery form (the form ``mul_comb4`` reads)
   beside its canonical option; ``to_affine`` at its six calls
   under ``affine_plan``'s group and at group 1; ``ring_fold`` at its two
   calls, also against Python integers and against the n ``field_mul``
   launches it replaced, timed too; the mesh's field kernels, off the
   main path, at the mesh's calls (``check_field_kernels``: ``field_mul``
   plain and pair form at FIELD_B rows a modulus, plain at [1536] and
   [128], its chain form at sharded_gk_total's [2048] x 12 beside the 12
   launches it replaced, ``field_sum`` at [2, 1536], [2, 128], [2048, 1]
   and [2, 1], edge rows first, each against Python integers too, with
   the kernels' device time from a ``torch.profiler`` trace and an empty
   kernel's at the same grid, the launch floor, beside the CUDA-event
   time, which at these sizes is the wrapper's rate); each bound counts
   the least work of the
   function on the call's data (a batch of inversions as one batch
   inversion), and the script raises if a bound it tightened grew; the
   launches per prove at the checked shapes must add up to the counts of
   phase 4a, and those per verify of ``straus_msm``, ``to_affine``,
   ``ring_fold``, ``ec_add`` and ``tree_sum`` to phase 4b's (a prove and
   a verify make one ``ring_fold`` and no ``field_mul`` launch); the
   parameter
   set-up's kernels (``comb8_bases``, ``comb8_entries``) come first, at
   its shapes (the P-256 h, R = 1; the Tom-256 g and h, R = 2), held
   against their plain versions and against the host oracle (the
   Python-integer table functions of ``DeviceParams``);
4. set-up: ``DeviceParams`` from a cold ``device_params_for`` cache, on
   the kernels (launch counts set to 0 just before and read just after:
   one launch of each kernel a curve), its tables against the host
   oracle's, and both times;
4a. the prover: ``BatchProver.prove`` on N=256 distinct instances at ring
   2^12 (instance i proves key i of the ring on tape SEED+100+i), one
   warm-up and three timed reps on the same tapes, each giving the same
   proof bytes; proofs 0..7 must equal, byte for byte, those of the host
   prover ``prove_signature_list`` run in worker processes meanwhile; the
   launch counts are read over the first timed rep; then one more prove
   under ``torch.profiler`` (``utils.profiling.trace``): the device's busy
   share of its wall, and the device time of each launch of ``ec_add``,
   ``tree_sum``, ``window_table``, ``comb4_entries`` and ``chord`` in the
   trace beside phase 3's CUDA-event times; then ``BatchProver.warmup(N)``
   (timed; every kernel of the prove path launched in it) and one more
   prove, whose launch counts and proof bytes must equal the timed rep's,
   which ran unwarmed; the host stages that hash (``challenges.hash``,
   ``subproof.hash``, ``tape.phase_a``, ``tape.phase_b``, ``gk.tape``)
   beside their shares of a prove when the host layer hashed with
   ``hashlib`` (``HASHLIB_STAGES``);
   phase 3 also holds the MSM backends' kernels (``bucket_sums``,
   ``bucket_fold``, ``msm_ladder``) against their plain versions, and
   ``straus_msm`` against them (the Straus-bucket crossover); the bucket
   kernels on ``bucket_plan``'s geometry and on each form it did not
   take (forced), and on the skewed and empty cases (``BUCKET_EDGE``);
   ``msm_ladder`` at ``LADDER`` and on its edge rows (``LADDER_EDGE``),
   with the kernel's device time apart from its tree;
4b. the verifier: ``BatchVerifier.verify`` on those 256 proofs, one
   warm-up and three timed reps, launch counts over the first; one more
   verify traced as the prove was; ``verify.host_prep`` beside its share
   of a verify with ``hashlib``; then one proof's GK response is tampered: exactly
   that position must fail (the per-row attribution path);
4c. path A: the same verify and tampered batch with
   ``Config.pippenger_min_t = 32``: the per-row MSMs take the bucket
   kernels (P-256 on the honest batch, both curves on the tampered one);
   the host scalar verifier must agree on proofs 0..7 and the tampered one;
4d. path B: the scalar verifier ``verify_signature_list`` under
   ``device_msm_backend()`` on those 9 proofs, one at a time in this
   process: the host verifier's verdicts, 3 ``straus_msm`` launches per
   honest proof and 1 for the tampered one;
4e. the hardened configuration (``hardened_pedersen = hardened_gk = 1``)
   at full width: a fresh parameter set (h by hash-to-curve), its
   ``DeviceParams`` on the kernels against the host oracle, one prove of
   the N instances after a warm-up (proofs 0..1 byte for byte against the
   host prover's under the same flags, in the worker processes), one
   verify (N x True), and the same batch with ``hardened_gk = 0`` (N x
   False); the default config is restored afterwards;
4f. ``examples/usage_batched_torch.py`` in a subprocess on the card at
   ``BATCH=4``: it must exit 0 (its verify asserts every proof True);
5. the mesh path (``zkecdsa_tpu_torch.parallel``), on 4a's inputs and
   tapes, in ranks spawned by ``parallel.launch``; each rank builds its
   ``DeviceParams`` on the kernels (timed, launches counted), proves and
   verifies (a warm-up, then one run with the launch counts set to 0
   just before it and read just after), must give 4a's proof bytes, 256 x
   True, and False at exactly the tampered position:
   5a. one rank on NCCL, a 1 x 1 mesh (the dp-sharded layout: the [N, E]
       phase B and the gathers);
   5b. four ranks sharing the one card over gloo, a 2 dp x 2 ring mesh
       (the ring-sharded GK routines: ``ring_fold`` on the low index bits,
       ``field_mul`` by the high bits' factors, ``field_sum``: one
       ``field_mul`` and one ``field_sum`` launch a rank a path);
   5c. in 5b's ranks, ``sharded_gk_total`` (ring 4096, n 12: one
       ``field_mul`` launch, the chain form, and two ``field_sum``),
       ``sharded_msm`` (8192 Tom-256 terms) and ``sharded_commit`` (N=256)
       against their unsharded counterparts, exactly (points affine);
   phase 3 holds the field kernels at the mesh path's shapes.  Four
   ranks on one card are no scaling measurement;
6. print the ``kernels`` JSON line (per kernel: its first checked shape's
   times, every shape's record under ``shapes``, ``prove_ms``, the
   kernel time of one prove summed over its shapes, and its launches per
   path), then the last line ``{"ok": true, "device": {...}}``.

Without CUDA (or without the package beside it) it exits non-zero and
prints no result.
"""

from __future__ import annotations

import dataclasses
import functools
import hashlib
import json
import multiprocessing
import os
import statistics
import subprocess
import sys
import time

N = 256  # proofs per batch (BatchProver.MAX_CHUNK, BatchVerifier.MAX_CHUNK)
RING = 4096  # ring 2^12
K = 8  # proofs also made by the host prover, compared byte for byte
REPS = 3  # timed reps of prove and of verify
TAMPER_AT = 37  # batch position whose GK response f[0] is tampered
SEED = 2024
DEVICE = "cuda"
S = 20  # verify rounds (Config.verify_rounds)
FIELD_B = 65536  # field_mul rows per modulus (plain and pair form)
# field_mul at the mesh path's calls (Tom-256 order): the high index bits'
# factors of the d-values (N_l * n = 128 * 12 rows) and of the recombination
FIELD_MUL = ((1536, "5b prove: sharded_gk_dvalues"), (128, "5b verify: sharded_gk_recombine"))
FIELD_CHAIN = (2048, 12)  # sharded_gk_total's chain a ring rank (4096 / 2 ring ranks, n)
FIELD_REPS = 20  # back-to-back calls a field case, timed with events and traced
# word-mask pairs (all-ones 32-bit words where a mask has bits) whose
# products take the P-256 prime's Solinas reduction through every
# correction (tests/torch_field_edges.py; tests/test_torch_field_p256.py
# shows what each exercises)
SOLINAS_MASKS = ((124, 124), (48, 160), (49, 164), (24, 160), (19, 189), (17, 181), (12, 128), (9, 171),
                 (6, 171), (4, 128), (3, 171), (0, 0), (1, 60), (1, 64), (2, 208), (4, 192), (2, 96),
                 (99, 175), (96, 175), (128, 128), (130, 190), (137, 182), (128, 129))
EC_B = 16384  # ec_add point pairs per curve
ROW_MSM = (256, 48)  # the verifier's per-row P-256 MSM [R, T] (43 terms padded to 48)
MSM = (16, 8192)  # the combined Tom-256 MSM's [R, T] at N=256, ring 2^12
ROUNDS = 80  # exp rounds per proof (sec_level)
CHORD_K = 10240  # phase-B rows: ~N*40 even rounds, a multiple of 512
PIPPENGER_MIN_T = 32  # path A: sends both per-row MSMs of the batch to the bucket kernels
# bucket kernels: (curve, R, T, window, rows of the plain bucket sums): the
# per-row P-256 MSM (T = 43 rounded to 48), the Tom-256 attribution MSM
# (756 -> 760) and the combined Tom-256 width
BUCKET = (("p256", 256, 48, 5, 256), ("tomEdwards256", 256, 760, 5, 8),
          ("tomEdwards256", 16, 8192, 6, 2))
# the bucket kernels' skewed and empty cases (curve, R, T, window, rows of
# the plain versions): every term of a row in one bucket, only the top
# window's digits nonzero, every scalar zero
BUCKET_EDGE = (("p256", 64, 48, 5, 16), ("tomEdwards256", 4, 8192, 6, 2))
BUCKET_EDGE_CASES = ("one_bucket", "top_window", "empty")
LADDER = (4, 1024)  # msm_ladder [R, T] on both curves
LADDER_EDGE = ((3, 37), (4, 1))  # msm_ladder's edge rows: a ragged shape, then T = 1
# field_sum [D, R] at the mesh path's calls: the prover's d-values (2 ring
# ranks, N_l * n = 128 * 12), the verifier's recombination, and
# sharded_gk_total's local sum (4096 / 2 ring elements) and its gathered
# partials
FIELD_SUM = ((2, 1536, "5b prove: sharded_gk_dvalues"), (2, 128, "5b verify: sharded_gk_recombine"),
             (2048, 1, "5c: sharded_gk_total's local sum"), (2, 1, "5c: sharded_gk_total's gathered partials"))
# phase 5: (name, backend, (dp, ring), run phase 5c in its ranks)
MESH_RUNS = (("5a", "nccl", (1, 1), False), ("5b", "gloo", (2, 2), True))
MESH_TIMEOUT = 420  # seconds for one mesh run's ranks
GK_TOTAL = (4096, 12)  # phase 5c sharded_gk_total [RING, n]
MESH_MSM_T = 8192  # phase 5c sharded_msm Tom-256 terms
# path B's one-row MSMs of one proof: GK membership (4n + 4), the exp
# relations on Tom-256 (a few hundred) and on P-256 (3 + 2 per round)
SCALAR_MSM = (("tomEdwards256", 52), ("tomEdwards256", 380), ("p256", 43))
# phase 2: sha256_rows [M, K] at the prover's rows: the challenge rows
# (pkX, pkY, then A, Tx, Ty a round: 2*67 + 80*199 bytes), the phase-B
# sub-proof rows (a mult proof's 9 points, an equality proof's 4, 67
# bytes each) and the GK challenge rows (4n commitments, n = 12)
HASH_ROWS = (("challenges.hash", 256, 134 + 80 * 199), ("subproof.hash, mult", 10240, 9 * 67),
             ("subproof.hash, equality", 10240, 4 * 67), ("GK challenge", 256, 48 * 67))
# sha256_batch: a verify's challenge messages (verify.host_prep)
HASH_BATCH = ("verify.host_prep", 256, 134 + 80 * 199)
# The last run of this script before the host layer hashed on the C++
# runtime, when it hashed with hashlib (NVIDIA H100 80GB HBM3, 700.00 W):
# the median wall and the hashing and tape stages' shares of the stages'
# seconds (None where the report did not keep the stage)
HASHLIB_STAGES = {
    "prove": (5.780, {"challenges.hash": None, "subproof.hash": 3.8, "tape.phase_a": 3.3,
                      "tape.phase_b": 24.9, "gk.tape": None}),
    "verify": (4.733, {"verify.host_prep": 20.9}),
}
EXAMPLE_BATCH = 4  # phase 4f: examples/usage_batched_torch.py's BATCH
EXAMPLE_TIMEOUT = 300  # seconds
COMB_W, COMB_E = 32, 256  # comb tables: 8-bit windows, multiples a window
K_HARD = 2  # phase 4e: proofs also made by the host prover with both flags on

# Bounds (H100 SXM, NVIDIA data sheet, at the full 700 W):
HBM_BYTES_PER_S = 3.35e12
# No tensor-core path exists for 32-bit modular products; they run on the
# INT32 pipes, 64 lanes per SM per clock, half the FP32 FMA lanes: half of
# 67 TFLOP/s / 2 flops per FMA = 16.75e12 IMAD/s.
IMAD_PER_S = 16.75e12
# One 9-limb Montgomery product: 81 limb products for a*b, 81 for q*p and
# 9 quotient digits; each 32x32->64-bit product is two IMADs (low, high).
IMAD_PER_MODMUL = 2 * (81 + 81 + 9)
# One product mod the P-256 prime by Solinas reduction (csrc/field.cuh
# fe_mul_p256): the 8x8-limb product's 64 wide products; the reduction is
# additions only
IMAD_PER_SOLINAS = 2 * 64
# Modular multiplies per point operation (csrc/curve.cuh)
MM_WEIER_ADD, MM_WEIER_DBL = 14, 13
MM_EDW_ADD, MM_EDW_DBL, MM_EDW_MIXED = 11, 9, 9


def _bound(modmuls: float, nbytes: float) -> tuple[float, str]:
    """Least time in ms for the work: the larger of the bytes over the
    memory rate and the IMADs over the INT32 rate."""
    t_ops = modmuls * IMAD_PER_MODMUL / IMAD_PER_S * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def _field_bound(f, products: int, nbytes: int) -> tuple[float, str]:
    """Bound of ``products`` modular products mod ``f`` and ``nbytes``
    moved: for the P-256 prime (``P256_P``, ``TOM_N``) a product is the
    Solinas one's IMADs, checked to be no looser than the Montgomery
    count it tightens."""
    old = _bound(products, nbytes)
    if f.p != 2**256 - 2**224 + 2**192 + 2**96 - 1:
        return old
    t_ops = products * IMAD_PER_SOLINAS / IMAD_PER_S * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    new = (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")
    return _no_looser(f"{f.name}: {products} products", new, old)


def _fermat_mm(p: int) -> int:
    """Products of the shortest fixed-window Fermat power a^(p-2), over
    windows of 1 (the binary ladder) to 6 bits: the table a^2..a^(2^w-1),
    w squarings a digit below the top one, and a product a nonzero digit
    (4 bits for each modulus here, csrc/field.cuh fe_inv)."""
    e = p - 2
    best = None
    for w in range(1, 7):
        digits = [(e >> (w * i)) & ((1 << w) - 1) for i in range(-(-e.bit_length() // w))]
        cost = (1 << w) - 2 + w * (len(digits) - 1) + sum(1 for d in digits[:-1] if d)
        best = cost if best is None else min(best, cost)
    return best


def _batch_inv_mm(p: int, B: int) -> int:
    """The least work of B inversions mod p: Montgomery's trick, 3(B-1)
    products and one Fermat inverse."""
    return 3 * max(B - 1, 0) + _fermat_mm(p) if B else 0


def _no_looser(what: str, new: tuple[float, str], old: tuple[float, str]) -> tuple[float, str]:
    """``new``, after checking that the tightened bound is no larger than
    the one it replaces at the same shape."""
    if new[0] > old[0]:
        raise AssertionError(f"{what}: the new bound {new[0]} ms exceeds the old {old[0]} ms")
    return new


def _straus_bound(ops, pts, dig) -> tuple[float, str]:
    """Bound of ``straus_msm`` on points [R, T, C, 9] and digits [R, T, 64],
    whatever its schedule: the least work of the algorithm on these inputs.
    A live term (not the identity, not every digit zero) costs its table
    (14 adds) and 64 adds, a row with a live term 256 doublings; the points
    and digits are read once and R sums written."""
    from zkecdsa_tpu_torch.ops.curve_ops import p256_ops
    from zkecdsa_tpu_torch.ops.field import NLIMBS

    mm_add, mm_dbl = (MM_WEIER_ADD, MM_WEIER_DBL) if ops is p256_ops else (MM_EDW_ADD, MM_EDW_DBL)
    live = ~ops.is_identity(pts) & (dig != 0).any(-1)  # [R, T]
    terms, rows = int(live.sum()), int(live.any(-1).sum())
    R, T = live.shape
    pb = NLIMBS * 4 * ops.NCOORD  # bytes per point
    return _bound(mm_dbl * rows * 256 + mm_add * terms * (14 + 64), R * T * (pb + 64) + R * pb)


# ---------------------------------------------------------------------------
# host proving and host verifying, in worker processes
# ---------------------------------------------------------------------------


def _set_hardened(flag: int) -> None:
    """Both hardened modes on (1) or off (0) in this process: a pool
    worker takes jobs of either kind, and the config is process-global."""
    from zkecdsa_tpu_torch.utils.config import get_config, set_config

    set_config(dataclasses.replace(get_config(), hardened_pedersen=flag, hardened_gk=flag))


def _prove_one(job):
    params_json, mh, sig, pub, which, ring, seed, hardened = job
    from zkecdsa_tpu_torch.serde import read_json, write_json
    from zkecdsa_tpu_torch.utils import rng
    from zkecdsa_tpu_torch.zkp_attest_list import (
        SignatureProofList,
        SystemParametersList,
        prove_signature_list,
    )

    _set_hardened(hardened)
    params = read_json(SystemParametersList, params_json)
    with rng.deterministic(seed):
        proof = prove_signature_list(params, mh, sig, pub, which, ring)
    return write_json(SignatureProofList, proof)


def _kernel_fns() -> dict:
    """Every kernel wrapper of the port by name; each counts its launches
    in ``.launches``."""
    from zkecdsa_tpu_torch.ops.curve_ops import (
        comb4_bases,
        comb4_entries,
        comb8_bases,
        comb8_entries,
        comb_mixed,
        comb_weier,
        ec_add,
        msm_ladder,
        mul_comb4,
        shamir,
        straus_msm,
        to_affine,
        tree_sum,
        window_table,
    )
    from zkecdsa_tpu_torch.ops.curve_ops import chord
    from zkecdsa_tpu_torch.ops.field import field_mul, field_sum, ring_fold
    from zkecdsa_tpu_torch.ops.msm_bucket import bucket_fold, bucket_sums

    return {fn.__name__: fn for fn in (
        field_mul, ring_fold, ec_add, tree_sum, window_table, to_affine, straus_msm, comb_mixed,
        shamir, comb4_bases, comb4_entries, mul_comb4, comb_weier, chord,
        bucket_sums, bucket_fold, msm_ladder, field_sum, comb8_bases, comb8_entries,
    )}


def _host_verify(job):
    params_json, mh, ring, proof_json, seed = job
    _set_hardened(0)
    from zkecdsa_tpu_torch.serde import read_json
    from zkecdsa_tpu_torch.utils import rng
    from zkecdsa_tpu_torch.zkp_attest_list import (
        SignatureProofList,
        SystemParametersList,
        verify_signature_list,
    )

    params = read_json(SystemParametersList, params_json)
    proof = read_json(SignatureProofList, proof_json)
    t0 = time.perf_counter()
    with rng.deterministic(seed):
        ok = verify_signature_list(params, mh, ring, proof)
    return ok, time.perf_counter() - t0


# ---------------------------------------------------------------------------
# phase 2: the host runtime against hashlib
# ---------------------------------------------------------------------------


def _best_ms(fn, reps: int = 3) -> float:
    """The least host wall time of ``reps`` calls, in ms."""
    best = None
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        dt = (time.perf_counter() - t0) * 1e3
        best = dt if best is None else min(best, dt)
    return best


def check_runtime(rs, log) -> list:
    """``libzkruntime.so`` runs, and its digests equal ``hashlib``'s on
    the DRBG's counter rows of one instance's tapes (recorded while the
    tapes are drawn as the prover draws them), on ``HASH_ROWS`` and on
    ``HASH_BATCH``'s messages; each timed beside ``hashlib``.  Raises on
    any difference."""
    import numpy as np

    from zkecdsa_tpu_torch.bignum import big
    from zkecdsa_tpu_torch.curves.instances import p256, tomEdwards256
    from zkecdsa_tpu_torch.runtime import native
    from zkecdsa_tpu_torch.utils import rng

    if not native.available():
        raise AssertionError(f"libzkruntime.so does not run: {native.error()}")
    drbg, rows = [], native.sha256_rows

    def record(a, threads=None):
        drbg.append(np.array(a, dtype=np.uint8))
        return rows(a, threads)

    native.sha256_rows = record
    try:  # phase A's draws, then phase B's for 40 even rounds
        src = rng.DeterministicSource(SEED + 100)
        n_ord, t_ord = p256.order, tomEdwards256.order
        big.rnd_many([n_ord, t_ord, t_ord] + [n_ord, n_ord, t_ord, t_ord] * ROUNDS, src)
        big.rnd_many([t_ord] * (40 * 40), src)
    finally:
        native.sha256_rows = rows
    cases = [(f"DRBG tape draw {i}", a) for i, a in enumerate(drbg)]
    cases += [(what, rs.randint(0, 256, (M, K)).astype(np.uint8)) for what, M, K in HASH_ROWS]
    recs = []
    for what, a in cases:
        got = native.sha256_rows(a)
        if [r.tobytes() for r in got] != [hashlib.sha256(r.tobytes()).digest() for r in a]:
            raise AssertionError(f"sha256_rows {list(a.shape)} ({what}) differs from hashlib")
        recs.append(dict(fn="sha256_rows", call=what, shape=list(a.shape),
                         ms=_best_ms(lambda: native.sha256_rows(a)),
                         ms_1_thread=_best_ms(lambda: native.sha256_rows(a, threads=1)),
                         hashlib_ms=_best_ms(lambda: [hashlib.sha256(r.tobytes()).digest() for r in a])))
    what, M, K = HASH_BATCH
    msgs = [rs.randint(0, 256, K - i % 3).astype(np.uint8).tobytes() for i in range(M)] + [b""]
    if native.sha256_batch(msgs) != [hashlib.sha256(m).digest() for m in msgs]:
        raise AssertionError(f"sha256_batch ({what}) differs from hashlib")
    recs.append(dict(fn="sha256_batch", call=what, shape=[len(msgs), K],
                     ms=_best_ms(lambda: native.sha256_batch(msgs)),
                     ms_1_thread=_best_ms(lambda: native.sha256_batch(msgs, threads=1)),
                     hashlib_ms=_best_ms(lambda: [hashlib.sha256(m).digest() for m in msgs])))
    threads = min(os.cpu_count() or 1, 16)
    with open("/proc/cpuinfo") as f:
        sha_ni = "sha_ni" in f.read().split()
    log(f"runtime: the host CPU {'has' if sha_ni else 'lacks'} the SHA extensions (sha_ni); "
        f"up to {threads} threads, one for each MiB of input (native.cpp)")
    for r in recs:
        log(f"runtime: {r['fn']} {r['shape']} ({r['call']}): {r['ms']:.3f} ms (one thread {r['ms_1_thread']:.3f}), "
            f"hashlib {r['hashlib_ms']:.3f} ms, exact")
    return recs


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------


def _cuda_ms(fn, reps: int) -> float:
    """Mean ms of ``fn`` over ``reps`` back-to-back calls, after one
    warm-up call, with CUDA events."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def _once_ms(fn):
    """(result, ms) of one synchronised call."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def _max_err(a, b) -> int:
    """Largest limb difference of two canonical limb tensors (uint32
    patterns held in int32); 0 when they are equal."""
    import torch

    if tuple(a.shape) != tuple(b.shape):
        raise AssertionError(f"shape {tuple(a.shape)} != {tuple(b.shape)}")
    if a.numel() == 0:
        return 0
    da = a.to(torch.int64) & 0xFFFFFFFF
    db = b.to(torch.int64) & 0xFFFFFFFF
    return int((da - db).abs().max())


def _exact(name: str, pairs) -> int:
    err = max(_max_err(a, b) for a, b in pairs)
    if err != 0:
        raise AssertionError(f"{name}: kernel disagrees with its plain version (max limb err {err})")
    return err


def _rescaled(ops, pts, n: int, rs, device):
    """n projective representatives cycling through host points ``pts``,
    each scaled by a random nonzero lambda: distinct coordinates for the
    same group elements, made with host integers."""
    p = ops.f.p
    coords = []
    for i in range(n):
        pt = pts[i % len(pts)]
        lam = int.from_bytes(rs.bytes(40), "little") % (p - 1) + 1
        coords.extend(c * lam % p for c in ops._host_coords(pt))
    return ops.f.pack(coords, device).reshape(n, ops.NCOORD, -1)


def check_kernels(dev, dparams, rs, log) -> dict:
    """Phase 3, every kernel of slice 1 at the verifier's shapes (the
    field kernels: :func:`check_field_kernels`).  Returns {name: shape
    record or records} (see :func:`_case`)."""
    import numpy as np
    import torch

    from zkecdsa_tpu_torch.ops.curve_ops import (
        ec_add,
        p256_ops,
        straus_msm,
        straus_plan,
        straus_teams,
        tom_ops,
    )
    from zkecdsa_tpu_torch.ops.field import NLIMBS, TOM_N, ring_fold_plain

    entries = {"to_affine": []}
    C_P = p256_ops.NCOORD
    pb = NLIMBS * 4  # bytes per field element

    # -- ring_fold at the verifier's shape (GK recombination) --------------
    n = RING.bit_length() - 1
    vals = TOM_N.pack([int.from_bytes(rs.bytes(40), "little") for _ in range(RING)], dev)
    fs = TOM_N.pack([int.from_bytes(rs.bytes(40), "little") for _ in range(N * n)], dev).reshape(N, n, -1)
    xfs = TOM_N.pack([int.from_bytes(rs.bytes(40), "little") for _ in range(N * n)], dev).reshape(N, n, -1)
    got, rec = _ring_fold_case(vals, fs, xfs, lambda: ring_fold_plain(vals, fs, xfs),
                               f"[{N}, {RING}] (verifier GK recombination)", 10, log, 0, 1)
    entries["ring_fold"] = [rec]
    # row 0 against Python integers
    q = TOM_N.p
    v_i, f_i, x_i = TOM_N.unpack(vals), TOM_N.unpack(fs[0]), TOM_N.unpack(xfs[0])
    tot = 0
    for k, v in enumerate(v_i):
        for j in range(n):
            v = v * (f_i[j] if (k >> j) & 1 else x_i[j]) % q
        tot = (tot + v) % q
    if TOM_N.unpack(got[0]) != [tot]:
        raise AssertionError("ring_fold disagrees with Python integers")

    # -- ec_add: EC_B pairs per curve with identity+P, P+P, P+(-P) rows -----
    from zkecdsa_tpu_torch.curves.instances import p256, tomEdwards256

    B = EC_B
    samples = {}
    for ops, g in ((p256_ops, p256), (tom_ops, tomEdwards256)):
        G = g.generator()
        pts = [G.mul(g.new_scalar(int.from_bytes(rs.bytes(32), "little") % g.order)) for _ in range(64)]
        P = _rescaled(ops, pts, B, rs, dev)
        Q = _rescaled(ops, pts[::-1], B, rs, dev)
        ident = ops.identity((), dev)
        Q[0] = P[0]  # P + P, same coordinates
        Q[1] = _rescaled(ops, [pts[1 % len(pts)]], 1, rs, dev)[0]  # P + P, other ones
        Q[2] = ops.neg(P[2])  # P + (-P)
        P[3] = ident  # identity + P
        P[4], Q[4] = ident, ident  # identity + identity
        got = ec_add(ops, P, Q)
        plain, plain_ms = _once_ms(lambda: ops.add(P, Q))
        err = _exact(f"ec_add[{g.name}]", [(got, plain)])
        host = ops.unpack_points(got[:8])
        hp, hq = ops.unpack_points(P[:8]), ops.unpack_points(Q[:8])
        if not all(r.eq(x.add(y)) for r, x, y in zip(host, hp, hq)):
            raise AssertionError(f"ec_add[{g.name}] disagrees with the host curve")
        if not host[2].is_identity():
            raise AssertionError(f"ec_add[{g.name}]: P + (-P) is not the identity")
        samples[g.name] = (P, got)
        ms = _cuda_ms(lambda: ec_add(ops, P, Q), 10)
        log(f"ec_add {g.name} B={B}: kernel {ms:.4f} ms, plain {plain_ms:.2f} ms, exact")
    # the verifier's shape: vphase T1 = T0 + Q over [N, S] P-256 points
    P = samples["p256"][0][: N * S].reshape(N, S, C_P, NLIMBS)
    Q = samples["p256"][1][: N * S].reshape(N, S, C_P, NLIMBS)
    _, entries["ec_add"] = _ec_add_case(p256_ops, P, Q, f"P-256 [{N}, {S}] (vphase T1 = T0 + Q)", 20, log,
                                        0, 1)

    # -- tree_sum at the verifier's two trees: the combined Tom-256 MSM's
    #    parts of each of its rows, then the sum of its rows ---------------
    R, T = MSM
    nparts = straus_plan(R, T, straus_teams(tom_ops, dev)).nparts
    pts = samples["tomEdwards256"][1]
    entries["tree_sum"] = [
        _tree_case(tom_ops, pts[: nparts * R].reshape(nparts, R, 4, NLIMBS),
                   f"Tom-256 [{nparts}, {R}] (verify: the combined MSM's parts a row)", 20, log,
                   1 if nparts > 1 else 0)[1],
        _tree_case(tom_ops, pts[: R], f"Tom-256 [{R}] (verify: the combined MSM's rows)", 20, log, 1)[1],
    ]

    # -- to_affine: the verifier's [N, S, 2] batches on both curves -------
    for ops, name, what in ((p256_ops, "p256", "P-256"), (tom_ops, "tomEdwards256", "Tom-256")):
        pts = samples[name][1][: N * S * 2].reshape(N, S, 2, ops.NCOORD, -1)
        got, rec = _affine_case(ops, pts, f"{what} [{N}, {S}, 2] (vphase)", 10, log, 0, 1)
        entries["to_affine"].append(rec)
        if ops is p256_ops and not bool(got[2].reshape(-1)[4]):  # identity + identity row
            raise AssertionError("to_affine: the identity is not flagged")

    # -- straus_msm at the verifier's three shapes: vphase's window muls
    #    [N*(S+1), 1] (Q = z1*G and T = m*R as one-term rows), the per-row
    #    P-256 MSM [N, 48] (43 terms padded with identity lanes) and the
    #    combined Tom-256 MSM -----------------------------------------------
    recs = []
    for ops, name, (R, T) in ((p256_ops, "p256", (N * (S + 1), 1)), (p256_ops, "p256", ROW_MSM),
                              (tom_ops, "tomEdwards256", MSM)):
        P = samples[name][0]
        src = torch.cat([P] * -(-R * T // P.shape[0]))[: R * T]
        pts = src.reshape(R, T, ops.NCOORD, -1).clone()
        dig = torch.from_numpy(rs.randint(0, 16, size=(R, T, 64)).astype(np.uint8)).to(dev)
        if T > 1:
            dig[:, :3] = 0  # zero scalars
            # the padding lanes: identity points with zero scalars
            pts[:, -5:] = ops.identity((), dev)
            dig[:, -5:] = 0
        else:
            dig[:3] = 0  # zero-scalar rows among the one-term rows
        got = straus_msm(ops, pts, dig)
        plain, plain_ms = _once_ms(lambda: ops.msm_shared(pts, dig))
        # the kernel adds in another order: compare the affine points
        ga, pa = ops.to_affine(got), ops.to_affine(plain)
        call = f"{name} [{R}, {T}]"
        err = _exact(f"straus_msm {call}", [(ga[0], pa[0]), (ga[1], pa[1]),
                                            (ga[2].to(torch.int32), pa[2].to(torch.int32))])
        ms = _cuda_ms(lambda: straus_msm(ops, pts, dig), 3)
        bound, by = _straus_bound(ops, pts, dig)
        teams = straus_teams(ops, dev)
        plan = dict(dataclasses.asdict(straus_plan(R, T, teams)), resident_teams=teams)
        recs.append(dict(
            call=call + " (verify)", launches_per_call=1, launches_per_prove=0, launches_per_verify=1,
            max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by, plan=plan,
        ))
        log(f"straus_msm {call}: kernel {ms:.4f} ms (plan {plan}), "
            f"plain {plain_ms:.1f} ms, bound {bound:.4f} ms, exact (affine)")
    entries["straus_msm"] = recs

    # -- comb_mixed: the vphase commits, [N, S, 2] rows -------------------
    d8 = torch.from_numpy(rs.randint(0, 256, size=(N, S, 2, 64)).astype(np.uint8)).to(dev)
    d8[0, 0, 0] = 0  # g*0 + h*0: the identity
    _, entries["comb_mixed"] = _comb_mixed_case(
        dparams["gh_t8"], d8, f"Tom-256 g*v + h*r, [{N}, {S}, 2] rows (vphase commits)", 10, log, 0
    )
    return entries


def _pairs(got, plain):
    """(kernel, plain) tensor pairs of one result: a tensor, or the (x, y,
    is_infinity) of ``to_affine``, or a tuple of results."""
    import torch

    if isinstance(got, torch.Tensor):
        return [(got, plain)]
    return [(a.to(torch.int32), b.to(torch.int32)) if a.dtype == torch.bool else (a, b)
            for a, b in zip(got, plain)]


def _case(name, call, kernel, plain, bound, reps, log, per_prove, per_call=1):
    """Hold ``kernel()`` against ``plain()`` exactly and time both: the
    kernel's result and one ``shapes`` record of the kernels line.  One
    timed call makes ``per_call`` launches; one prove makes ``per_prove``
    at this shape."""
    got = kernel()
    want, plain_ms = _once_ms(plain)
    err = _exact(f"{name} {call}", _pairs(got, want))
    ms = _cuda_ms(kernel, reps)
    log(f"{name} {call}: kernel {ms:.4f} ms, plain {plain_ms:.1f} ms, exact")
    b, by = bound
    return got, dict(call=call, launches_per_call=per_call, launches_per_prove=per_prove,
                     max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b, bound_by=by)


def _geometry_case(name, call, run, plain, B, bound, reps, log, per_prove, device):
    """A comb kernel (``comb_mixed``, ``comb_weier``, ``mul_comb4``) on
    one call's B rows: ``run(lanes)`` under ``comb_plan``'s geometry
    (``lanes=None``, the path's) and under the other one (forced), each
    held exactly against ``plain()`` and timed; the kernel's result and
    one ``shapes`` record with the plan and both times."""
    from zkecdsa_tpu_torch.ops.curve_ops import comb_plan, comb_resident

    got, rec = _case(name, call, lambda: run(None), plain, bound, reps, log, per_prove)
    resident = comb_resident(device, name)
    plan = comb_plan(B, resident)
    other = 1 if plan.lanes == 4 else 4
    # the other geometry against the plan's result, which equals the plain one
    err = _exact(f"{name} {call} lanes={other}", [(run(other), got)])
    ms_other = _cuda_ms(lambda: run(other), reps)
    rec.update(max_abs_err=max(rec["max_abs_err"], err), other_lanes=other, ms_other=ms_other,
               plan=dict(dataclasses.asdict(plan), resident_rows=resident))
    log(f"{name} {call}: plan {rec['plan']}: {rec['ms']:.4f} ms; {other} lanes a row: "
        f"{ms_other:.4f} ms, exact; bound {bound[0]:.4f} ms")
    return got, rec


def _comb_mixed_case(comb, d8, call, reps, log, per_prove):
    """``comb_mixed`` on one call's digits d8 [..., 64], row 0 all zero,
    under both geometries (:func:`_geometry_case`).  The bound counts 9
    products a window (one mixed add), the table read once, the digits
    and the outputs."""
    from zkecdsa_tpu_torch.ops.curve_ops import comb_mixed, tom_ops
    from zkecdsa_tpu_torch.ops.field import NLIMBS

    B = d8.shape[:-1].numel()
    bound = _bound(MM_EDW_MIXED * 64 * B, comb.mont.numel() * 4 + d8.numel() + B * 4 * NLIMBS * 4)
    got, rec = _geometry_case("comb_mixed", call, lambda lanes: comb_mixed(comb, d8, lanes=lanes),
                              lambda: tom_ops.mul_comb_mixed(comb.canon, d8), B, bound, reps, log,
                              per_prove, d8.device)
    if not bool(tom_ops.is_identity(got.view(-1, 4, NLIMBS)[0])):
        raise AssertionError("comb_mixed: zero digits do not give the identity")
    return got, rec


def _affine_bound(ops, B: int):
    """Bound of ``to_affine`` on B points: one batch inversion of their Z
    (:func:`_batch_inv_mm`) and two products a point for x and y; C
    coordinates in, x, y and a flag out.  Checked no larger than the
    bound it replaced, a binary-ladder inverse a point."""
    from zkecdsa_tpu_torch.ops.field import NLIMBS

    p = ops.f.p
    pb = NLIMBS * 4
    nbytes = B * (ops.NCOORD * pb + 2 * pb + 1)
    ladder = (p - 2).bit_length() - 1 + bin(p - 2).count("1") - 1
    return _no_looser(f"to_affine [{B}]", _bound(_batch_inv_mm(p, B) + 2 * B, nbytes),
                      _bound((ladder + 2) * B, nbytes))


def _affine_case(ops, pts, call, reps, log, per_prove, per_verify):
    """``to_affine`` on one call's points under ``affine_plan``'s group,
    held exactly against the plain version and timed, and timed again at
    group 1 (an inverse a point); one ``shapes`` record with the plan and
    both times."""
    from zkecdsa_tpu_torch.ops.curve_ops import affine_plan, affine_threads, to_affine

    B = pts.shape[:-2].numel()
    got, rec = _case("to_affine", call, lambda: to_affine(ops, pts), lambda: ops.to_affine(pts),
                     _affine_bound(ops, B), reps, log, per_prove)
    threads = affine_threads(ops, pts.device)
    plan = affine_plan(B, threads)
    ms_g1 = _cuda_ms(lambda: to_affine(ops, pts, group=1), reps)
    rec.update(launches_per_verify=per_verify, ms_group1=ms_g1,
               plan=dict(dataclasses.asdict(plan), affine_threads=threads))
    log(f"to_affine {call}: plan {rec['plan']}: {rec['ms']:.4f} ms; group 1: {ms_g1:.4f} ms; "
        f"bound {rec['bound_ms']:.5f} ms")
    return got, rec


def _ring_fold_levels(vals, f, xf):
    """The design ``ring_fold`` replaced, timed beside it: one pair-form
    ``field_mul`` launch a ring-index bit, each level through HBM."""
    from zkecdsa_tpu_torch.ops.field import NLIMBS, TOM_N, field_mul

    N = f.shape[0]
    T = vals[None].expand(N, vals.shape[0], NLIMBS)
    for j in range(f.shape[1]):
        K = T.shape[1] // 2
        T = field_mul(TOM_N, xf[:, j : j + 1].expand(N, K, NLIMBS), T[:, 0::2],
                      f[:, j : j + 1].expand(N, K, NLIMBS), T[:, 1::2])
    return T[:, 0]


def _ring_fold_case(vals, fs, xfs, plain, call, reps, log, per_prove, per_verify):
    """``ring_fold`` on [N, RING]: exact against ``plain()`` (the plain
    version) and against the previous design's n ``field_mul`` launches,
    both timed; one ``shapes`` record.  The bound counts 2 products a pair
    output, 2^n - 1 of them a row."""
    from zkecdsa_tpu_torch.ops.field import NLIMBS, ring_fold

    M, n = fs.shape[0], fs.shape[1]
    pb = NLIMBS * 4
    bound = _bound(2 * M * (vals.shape[0] - 1), (vals.shape[0] + 2 * M * n + M) * pb)
    got, rec = _case("ring_fold", call, lambda: ring_fold(vals, fs, xfs), plain, bound, reps, log, per_prove)
    err = _exact(f"ring_fold {call} vs the field_mul levels", [(_ring_fold_levels(vals, fs, xfs), got)])
    ms_levels = _cuda_ms(lambda: _ring_fold_levels(vals, fs, xfs), reps)
    rec.update(launches_per_verify=per_verify, max_abs_err=max(rec["max_abs_err"], err), ms_field_mul_levels=ms_levels)
    log(f"ring_fold {call}: {rec['ms']:.4f} ms in one launch; the {n} field_mul levels it replaced: "
        f"{ms_levels:.4f} ms; bound {bound[0]:.4f} ms")
    return got, rec


def _add_bound(ops, B: int):
    """Bound of ``ec_add`` on B point pairs."""
    from zkecdsa_tpu_torch.ops.curve_ops import p256_ops
    from zkecdsa_tpu_torch.ops.field import NLIMBS

    mm = MM_WEIER_ADD if ops is p256_ops else MM_EDW_ADD
    return _bound(mm * B, 3 * B * ops.NCOORD * NLIMBS * 4)


def _ec_add_case(ops, P, Q, call, reps, log, per_prove, per_verify=0):
    """``ec_add`` (a team of four lanes a pair) on one call's pairs, held
    exactly against the plain version and timed, beside the one-thread
    kernel it replaced (``tools/torch_ec_add_sweep.py``), held against it
    and timed too."""
    from tools.torch_ec_add_sweep import one_thread_ec_add
    from zkecdsa_tpu_torch.ops.curve_ops import ec_add

    B = P.shape[:-2].numel()
    got, rec = _case("ec_add", call, lambda: ec_add(ops, P, Q), lambda: ops.add(P, Q), _add_bound(ops, B),
                     reps, log, per_prove)
    err = _exact(f"ec_add {call} vs one thread a pair", [(one_thread_ec_add(ops, P, Q), got)])
    ms_thread = _cuda_ms(lambda: one_thread_ec_add(ops, P, Q), reps)
    rec.update(launches_per_verify=per_verify, max_abs_err=max(rec["max_abs_err"], err),
               ms_one_thread=ms_thread)
    log(f"ec_add {call}: a team a pair {rec['ms']:.4f} ms; one thread a pair (the kernel it replaced) "
        f"{ms_thread:.4f} ms, exact; bound {rec['bound_ms']:.5f} ms")
    return got, rec


def _ec_add_levels(ops, P):
    """The design ``tree_sum`` replaced, timed beside it: the plain
    tree's levels as one ``ec_add`` launch each."""
    import torch

    from zkecdsa_tpu_torch.ops.curve_ops import ec_add

    while P.shape[0] > 1:
        h = P.shape[0] // 2
        P = torch.cat([ec_add(ops, P[:h], P[h : 2 * h]), P[2 * h :]], dim=0)
    return P[0]


def _tree_case(ops, P, call, reps, log, per_verify):
    """``tree_sum`` on [n, M] points, held exactly against the plain
    version and against the ``ec_add`` level loop it replaced, both
    timed.  The bound counts the tree's n - 1 adds a column, the points
    read once and the M sums written."""
    from zkecdsa_tpu_torch.ops.curve_ops import p256_ops, tree_sum
    from zkecdsa_tpu_torch.ops.field import NLIMBS

    n, M = P.shape[0], P.shape[1:-2].numel()
    mm = MM_WEIER_ADD if ops is p256_ops else MM_EDW_ADD
    bound = _bound(mm * (n - 1) * M, (n * M + M) * ops.NCOORD * NLIMBS * 4)
    got, rec = _case("tree_sum", call, lambda: tree_sum(ops, P), lambda: ops.sum_reduce(P), bound, reps,
                     log, 0)
    err = _exact(f"tree_sum {call} vs the ec_add levels", [(_ec_add_levels(ops, P), got)])
    ms_levels = _cuda_ms(lambda: _ec_add_levels(ops, P), reps)
    levels = (n - 1).bit_length()
    rec.update(launches_per_verify=per_verify, max_abs_err=max(rec["max_abs_err"], err),
               ms_ec_add_levels=ms_levels, ec_add_levels=levels)
    log(f"tree_sum {call}: {rec['ms']:.4f} ms in one launch; the {levels} ec_add levels it replaced: "
        f"{ms_levels:.4f} ms; bound {bound[0]:.5f} ms")
    return got, rec


def _table_bound(ops, B: int):
    """Bound of ``window_table`` on B points: the least work of a table of
    the multiples 0..15, 14 adds a point (entry 1 is P itself), as
    :func:`_straus_bound` counts a term's table; B points read and 16 B
    entries written."""
    from zkecdsa_tpu_torch.ops.curve_ops import p256_ops
    from zkecdsa_tpu_torch.ops.field import NLIMBS

    mm = MM_WEIER_ADD if ops is p256_ops else MM_EDW_ADD
    return _bound(mm * 14 * B, 17 * B * ops.NCOORD * NLIMBS * 4)


def _ec_add_table(ops, P):
    """The design ``window_table`` replaced, timed beside it: the table
    as 15 ``ec_add`` launches, entry k = entry k-1 + P."""
    import torch

    from zkecdsa_tpu_torch.ops.curve_ops import ec_add

    out = [ops.identity(P.shape[:-2], P.device)]
    for _ in range(15):
        out.append(ec_add(ops, out[-1], P))
    return torch.stack(out, dim=-3)


def check_prover_kernels(dev, dparams, rs, log) -> dict:
    """Phase 3, every kernel of one prove at N=256, ring 2^12, at the
    shapes the prover gives it.  Returns {name: [shape record, ...]}; the
    ``launches_per_prove`` of a kernel's records sum to its count in one
    prove (checked against phase 4a)."""
    import numpy as np
    import torch

    from zkecdsa_tpu_torch.curves.instances import p256
    from zkecdsa_tpu_torch.ops.curve_ops import (
        comb4_bases,
        comb4_entries,
        comb4_table,
        comb_weier,
        CHORD_IN,
        CHORD_OUT,
        chord,
        chord_plain,
        ec_add,
        mul_comb4,
        p256_ops,
        shamir,
        tom_ops,
        window_table,
    )
    from zkecdsa_tpu_torch.ops.field import NLIMBS, TOM_N, ring_fold_plain

    shapes: dict[str, list] = {}

    def case(name, call, kernel, plain, bound, reps, per_prove, per_call=1):
        got, rec = _case(name, call, kernel, plain, bound, reps, log, per_prove, per_call)
        shapes.setdefault(name, []).append(rec)
        return got

    def affine(ops, pts, call, reps):
        got, rec = _affine_case(ops, pts, call, reps, log, 1, 0)
        shapes.setdefault("to_affine", []).append(rec)
        return got

    def add(ops, P, Q, call):
        got, rec = _ec_add_case(ops, P, Q, call, 20, log, 1)
        shapes.setdefault("ec_add", []).append(rec)
        return got

    ops = p256_ops
    pb = NLIMBS * 4
    pt_b = 3 * pb  # bytes per P-256 point
    K = CHORD_K
    n = RING.bit_length() - 1
    G = p256.generator()
    host = [G.mul(p256.new_scalar(int.from_bytes(rs.bytes(32), "little") % p256.order)) for _ in range(64)]
    P = _rescaled(ops, host, N, rs, dev)

    def u8(*shape, hi):
        return torch.from_numpy(rs.randint(0, hi, size=shape).astype(np.uint8)).to(dev)

    # -- phase A: the window tables of pk and R, one window_table launch
    #    each (the 15 ec_add launches a table they replaced timed beside
    #    them), then comS1 = sR + Hc and D = Q + (-sR) in one [N, 2]
    #    ec_add launch (the two [N] launches it merged timed beside it) ---
    tab = case("window_table", f"P-256 [{N}] -> [{N}, 16, 3, 9] (phase A: the tables of pk and R)",
               lambda: window_table(ops, P), lambda: ops.table(P), _table_bound(ops, N), 20, 2)
    _exact("window_table vs the 15 ec_add launches", [(_ec_add_table(ops, P), tab)])
    ms_loop = _cuda_ms(lambda: _ec_add_table(ops, P), 20)
    shapes["window_table"][-1]["ms_15_ec_add"] = ms_loop
    log(f"window_table [{N}]: {shapes['window_table'][-1]['ms']:.4f} ms in one launch; the 15 ec_add "
        f"launches it replaced: {ms_loop:.4f} ms")
    P2 = tab[:, [7, 3]].contiguous()
    Q2 = torch.stack([P, ops.neg(tab[:, 5])], dim=1)
    add(ops, P2, Q2, f"P-256 [{N}, 2] (phase A: comS1 and D in one launch)")
    P2a, P2b, Q2a, Q2b = (t.contiguous() for t in (P2[:, 0], P2[:, 1], Q2[:, 0], Q2[:, 1]))
    _exact("ec_add [N, 2] vs two [N] launches",
           [(torch.stack([ec_add(ops, P2a, Q2a), ec_add(ops, P2b, Q2b)], dim=1), ec_add(ops, P2, Q2))])
    ms_apart = _cuda_ms(lambda: (ec_add(ops, P2a, Q2a), ec_add(ops, P2b, Q2b)), 20)
    shapes["ec_add"][-1]["ms_two_launches"] = ms_apart
    log(f"ec_add [{N}, 2]: {shapes['ec_add'][-1]['ms']:.4f} ms; as two [{N}] launches {ms_apart:.4f} ms")

    # -- shamir: the [N] call (shared G table, per-row tables: R = u1*G +
    #    u2*PK) and the [N, 2] call (per-row tables and the shared G table
    #    against the shared G table with zero digits: s1*R and Q = z1*G) ---
    tG = dparams["G"]
    d1, d2 = u8(N, 64, hi=16), u8(N, 64, hi=16)
    d1[0] = 0
    tp = torch.stack([tab, tG.expand_as(tab)], dim=1)
    dP = u8(N, 2, 64, hi=16)
    dQ = torch.zeros_like(dP)
    # a column is 4 doublings and one add per table whose digits are used:
    # both in the [N] call; only tp's in the [N, 2] call, whose dQ is zero
    R = case(
        "shamir", f"P-256 [{N}] (phase A: R = u1*G + u2*PK)",
        lambda: shamir(tG, d1, tab, d2), lambda: ops.double_mul_tables(tG, d1, tab, d2),
        _bound(N * 64 * (4 * MM_WEIER_DBL + 2 * MM_WEIER_ADD),
               N * 16 * pt_b + 16 * pt_b + 2 * N * 64 + N * pt_b), 5, 1,
    )
    cq = case(
        "shamir", f"P-256 [{N}, 2] (phase A: s1*R and Q = z1*G, zero second digits)",
        lambda: shamir(tp, dP, tG, dQ), lambda: ops.double_mul_tables(tp, dP, tG, dQ),
        _bound(2 * N * 64 * (4 * MM_WEIER_DBL + MM_WEIER_ADD),
               N * 16 * pt_b + 16 * pt_b + 2 * N * 64 + 2 * N * pt_b), 5, 1,
    )

    # -- comb4: position bases, entries in Montgomery form (the form
    #    mul_comb4 reads; the canonical option checked and timed beside
    #    them), then N x 80 scalars under both geometries ----------------
    bases = case(
        "comb4_bases", f"P-256 [{N}] bases -> [{N}, 64, 3, 9] (252 doublings each)",
        lambda: comb4_bases(P), lambda: ops.comb4_bases(P),
        _bound(N * 63 * 4 * MM_WEIER_DBL, N * pt_b + N * 64 * pt_b), 5, 1,
    )
    # its geometry (csrc/comb4.cu): a team of four lanes a base, 8 bases to
    # a one-warp block
    shapes["comb4_bases"][-1]["plan"] = dict(lanes=4, rows_per_block=8, blocks=-(-N // 8))
    f = ops.f
    r_mont = f.const((1 << 288) % f.p, dev)  # x -> x * 2^288 mod p, the plain conversion
    tab4 = case(
        "comb4_entries", f"P-256 [{N}, 64] position bases -> [{N}, 64, 16, 3, 9] (Montgomery form)",
        lambda: comb4_entries(bases), lambda: f.mul(ops.comb4_entries(bases), r_mont),
        _bound(N * 64 * (3 * MM_WEIER_DBL + 14 * MM_WEIER_ADD), N * 64 * 17 * pt_b), 10, 1,
    )
    tab4c = comb4_entries(bases, canon=True)
    _exact("comb4_entries (canonical option)", [(tab4c, ops.comb4_entries(bases)), (f.from_mont(tab4), tab4c)])
    _exact("comb4_table", [(comb4_table(P, canon=True), tab4c), (comb4_table(P), tab4)])
    _exact("comb4_table vs the plain version", [(tab4c, ops.comb4_table(P))])
    ms_canon = _cuda_ms(lambda: comb4_entries(bases, canon=True), 10)
    shapes["comb4_entries"][-1]["ms_canonical_option"] = ms_canon
    log(f"comb4_entries: the canonical option {ms_canon:.4f} ms, exact")
    dig = u8(N, ROUNDS, 64, hi=16)
    dig[0, 0] = 0
    T, rec = _geometry_case(
        "mul_comb4", f"P-256 [{N}, {ROUNDS}] scalars from per-base tables in Montgomery form (phase A T)",
        lambda lanes: mul_comb4(tab4, dig, lanes=lanes), lambda: ops.mul_comb4(tab4c, dig), N * ROUNDS,
        _bound(N * ROUNDS * 64 * MM_WEIER_ADD, tab4.numel() * 4 + dig.numel() + N * ROUNDS * pt_b),
        5, log, 1, dev,
    )
    shapes.setdefault("mul_comb4", []).append(rec)
    if not bool(ops.is_identity(T[0, 0])):
        raise AssertionError("mul_comb4: zero digits do not give the identity")

    # -- comb_weier on the Montgomery table of h: phase A's one call, [N,
    #    81] rows (the rounds' r*h, then com_r*h); then the two calls it
    #    merged, [N] and [N, 80], timed apart (no launch a prove) ---------
    comb = dparams["comb_h_n8"]

    def weier(call, d8, per_prove):
        rows = d8.shape[:-1].numel()
        bound = _bound(rows * 32 * MM_WEIER_ADD, comb.mont.numel() * 4 + rows * (32 + pt_b))
        got, rec = _geometry_case(
            "comb_weier", call, lambda lanes: comb_weier(comb, d8, lanes=lanes),
            lambda: ops.mul_comb(comb.canon, d8), rows, bound, 5, log, per_prove, dev,
        )
        shapes.setdefault("comb_weier", []).append(rec)
        return got

    c81 = u8(N, ROUNDS + 1, 32, hi=256)
    c81[0, ROUNDS] = 0  # com_r = 0
    H = weier(f"P-256 [{N}, {ROUNDS + 1}] rows (phase A: Hr = r*h and Hc = com_r*h in one call)", c81, 1)
    if not bool(ops.is_identity(H[0, ROUNDS])):
        raise AssertionError("comb_weier: zero digits do not give the identity")
    Hr = H[:, :ROUNDS]
    weier(f"P-256 [{N}] rows (Hc alone, as a call of its own)", c81[:, ROUNDS], 0)
    weier(f"P-256 [{N}, {ROUNDS}] rows (Hr alone, as a call of its own)", c81[:, :ROUNDS], 0)

    # -- phase A: A = T + Hr, then one P-256 affine pass [N, 3 + 80 + 80] --
    A = add(ops, T, Hr, f"P-256 [{N}, {ROUNDS}] (A = T + Hr)")
    small = torch.stack([R, cq[:, 1], cq[:, 0]], dim=1)
    aff_in = torch.cat([small, T, A], dim=1)
    affine(ops, aff_in, f"P-256 [{N}, {aff_in.shape[1]}] (phase A)", 10)

    # -- phase B: T1 = T + D over [K] rows, then one chord launch: T1's
    #    affine pass and the chord pass, one inverse a row; the pair it
    #    replaced (to_affine [K], then the old chord kernel, from
    #    tools/torch_chord_probe.py) timed beside it ----------------------
    Te, De = T.reshape(-1, 3, NLIMBS)[:K], A.reshape(-1, 3, NLIMBS)[:K]
    T1 = add(ops, Te, De, f"P-256 [{K}] (phase B T1 = T + D)").clone()
    q = TOM_N.p
    x = TOM_N.pack(
        [int.from_bytes(rs.bytes(40), "little") % q for _ in range(K * len(CHORD_IN))], dev
    ).reshape(K, len(CHORD_IN), -1)
    T1[0] = ops.identity((), dev)  # Z = 0
    t1x, t1y, _ = ops.to_affine(T1[:4])
    x[1, 0] = t1x[1]  # i7 = 0
    x[2, 0] = 0
    T1[2] = ops.identity((), dev)  # both
    # the least work: one batch inversion of the K products a b, and 22
    # products a row (pkx Z, a b, 1/Z = b w, i8 = a (a w), t1x, t1y, i10,
    # i11, i13, 4 kx y, 4 x rb, 4 kx rb); against the two bounds it
    # replaces, to_affine [K]'s and the old chord pass's (its 3 + 16
    # products a row and one batch inversion)
    ladder = (q - 2).bit_length() - 1 + bin(q - 2).count("1") - 1
    nbytes = K * (3 + len(CHORD_IN) + len(CHORD_OUT)) * pb
    old_chord = _no_looser(f"old chord [{K}]", _bound(_batch_inv_mm(q, K) + K * (3 + 16), K * (15 + 23) * pb),
                           _bound(K * (ladder + 3 + 16), K * (15 + 23) * pb))
    old_affine = _affine_bound(ops, K)
    bound = _no_looser(f"chord [{K}]", _bound(_batch_inv_mm(q, K) + K * 22, nbytes),
                       (old_chord[0] + old_affine[0], "operations"))
    y = case("chord", f"[{K}] phase-B rows: T1's affine pass and the chord pass mod the Tom-256 order",
             lambda: chord(T1, x), lambda: chord_plain(T1, x), bound, 10, 1)
    # the zero rows against Python integers: T1 the identity (Z = 0), i7 =
    # 0, both; then a random row
    X = [TOM_N.unpack(x[k])[0] for k in range(4)]
    if TOM_N.unpack(y[0, :4]) != [0, 0, X[0], pow(X[0], q - 2, q)]:
        raise AssertionError("chord: the identity's row disagrees with Python integers")
    if TOM_N.unpack(y[1, 2:4]) != [0, 0] or TOM_N.unpack(y[2, :4]) != [0, 0, 0, 0]:
        raise AssertionError("chord: the inverse of 0 is not 0")
    X3, Y3, Z3 = TOM_N.unpack(T1[3])
    t1x3 = X3 * pow(Z3, q - 2, q) % q
    i7 = (X[3] - t1x3) % q
    if TOM_N.unpack(y[3, :4]) != [t1x3, Y3 * pow(Z3, q - 2, q) % q, i7, pow(i7, q - 2, q)]:
        raise AssertionError("chord disagrees with Python integers")
    # the pair it replaced, in the same run
    from tools.torch_chord_probe import old_chord_pair

    pair, pair_err = old_chord_pair(T1, x, y, _cuda_ms)
    rec = shapes["chord"][-1]
    rec.update(ms_pair=pair["pair"], ms_pair_to_affine=pair["to_affine"], ms_pair_old_chord=pair["old_chord"],
               max_abs_err=max(rec["max_abs_err"], pair_err), bound_ms_pair=old_chord[0] + old_affine[0])
    log(f"chord [{K}]: {rec['ms']:.4f} ms in one launch; the pair it replaced {pair['pair']:.4f} ms "
        f"(to_affine [{K}] {pair['to_affine']:.4f}, the old chord kernel {pair['old_chord']:.4f}); bound "
        f"{bound[0]:.5f} ms (the two old bounds {old_chord[0] + old_affine[0]:.5f})")

    # -- Tom-256 commitments: phase A [N, 162], phase B [K, 34], GK [N*4n] --
    def commits(call, batch):
        d8 = u8(*batch, 64, hi=256)
        d8.view(-1, 64)[0] = 0  # g*0 + h*0: the identity
        out, rec = _comb_mixed_case(dparams["gh_t8"], d8, call, 3, log, 1)
        shapes.setdefault("comb_mixed", []).append(rec)
        return out

    allC = commits(f"Tom-256 [{N}, 162] (phase A commits)", (N, 162))
    cm = commits(f"Tom-256 [{K}, 34] (phase B commits)", (K, 34))
    gk = commits(f"Tom-256 [{N * 4 * n}] (GK commits)", (N * 4 * n,))
    # the phase-B combinations: [K, 5] differences, then cintX [K]
    sP, sQ = cm[:, :5].contiguous(), tom_ops.neg(cm[:, 5:10]).contiguous()
    s5 = add(tom_ops, sP, sQ, f"Tom-256 [{K}, 5] (phase B differences)")
    cP, cQ = s5[:, 3].contiguous(), cm[:, 0].contiguous()
    add(tom_ops, cP, cQ, f"Tom-256 [{K}] (phase B cintX)")
    for call, pts in ((f"Tom-256 [{N}, 162] (phase A)", allC),
                      (f"Tom-256 [{K}, 39] (phase B)", torch.cat([cm, s5], dim=1)),
                      (f"Tom-256 [{N * 4 * n}] (GK commits)", gk)):
        affine(tom_ops, pts, call, 5)

    # -- GK d-values: one ring_fold over N*n rows; the plain version runs
    #    over N instances at a time (the same function; one call over all
    #    rows would hold ~20 GB of products) -------------------------------
    M = N * n
    vals = TOM_N.pack([int.from_bytes(rs.bytes(40), "little") % q for _ in range(RING)], dev)
    fs = TOM_N.pack([int.from_bytes(rs.bytes(40), "little") % q for _ in range(M * n)], dev).reshape(M, n, -1)
    xfs = TOM_N.pack([int.from_bytes(rs.bytes(40), "little") % q for _ in range(M * n)], dev).reshape(M, n, -1)

    def fold_plain():
        return torch.cat([ring_fold_plain(vals, fs[i : i + N], xfs[i : i + N]) for i in range(0, M, N)])

    _, rec = _ring_fold_case(vals, fs, xfs, fold_plain, f"[{M}, {RING}] (GK d-values)", 3, log, 1, 0)
    shapes.setdefault("ring_fold", []).append(rec)
    return shapes


def _affine_exact(name, ops, got, want) -> int:
    """Compare two batches of points as group elements (the kernel adds in
    another order than the plain version): canonical affine coordinates
    and the infinity flag, tolerance 0."""
    import torch

    ga, wa = ops.to_affine(got), ops.to_affine(want)
    return _exact(name, [(ga[0], wa[0]), (ga[1], wa[1]),
                         (ga[2].to(torch.int32), wa[2].to(torch.int32))])


def _msm_inputs(ops, g, R, T, rs, dev):
    """R rows of T terms on the card: random points (distinct projective
    coordinates), random scalars with 0, 1, order - 1 and a duplicate at
    the head of each row, and an identity point with scalar 0 at its end
    (the verifier's padding lanes)."""
    G = g.generator()
    host = [G.mul(g.new_scalar(int.from_bytes(rs.bytes(32), "little") % g.order)) for _ in range(64)]
    P = _rescaled(ops, host, R * T, rs, dev).reshape(R, T, ops.NCOORD, -1)
    P[:, -1] = ops.identity((), dev)
    scs = [[int.from_bytes(rs.bytes(32), "little") % g.order for _ in range(T)] for _ in range(R)]
    for row in scs:
        row[:4] = [0, 1, g.order - 1, row[4]]
        row[-1] = 0
    return P, scs


def _ladder_edge_inputs(ops, g, R, T, rs, dev):
    """msm_ladder's edge rows (R >= 3) from ``tests/torch_ladder_edges.py``
    (every bit zero, every bit one, the identity point as a term; the
    tests' definition), as random projective representatives."""
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests"))
    from torch_ladder_edges import ladder_edge_rows

    pts, scs, _ = ladder_edge_rows(g, rs, R, T)
    return _rescaled(ops, pts, R * T, rs, dev).reshape(R, T, ops.NCOORD, -1), scs


def check_msm_kernels(dev, rs, log) -> tuple[dict, list]:
    """Phase 3, slice 3: ``bucket_sums`` and ``bucket_fold`` at the bucket
    backend's shapes (each against its plain version, and the two
    together against ``straus_msm`` on every row, the crossover),
    ``msm_ladder`` against its plain version and ``straus_msm`` (each
    record with the kernel's ``device_ms`` apart from its tree), and
    ``straus_msm`` at the scalar verifier's one-row shapes against the
    plain ``msm``.  Returns ({name: [shape record, ...]}, crossover)."""
    import numpy as np
    import torch

    from zkecdsa_tpu_torch.curves.instances import p256, tomEdwards256
    from zkecdsa_tpu_torch.ops.curve_ops import (
        msm,
        msm_ladder,
        nibble_digits,
        p256_ops,
        scalar_bits,
        straus_msm,
        straus_plan,
        straus_teams,
        tom_ops,
    )
    from zkecdsa_tpu_torch.ops.field import NLIMBS
    from zkecdsa_tpu_torch.ops.msm_bucket import (
        bucket_fold,
        bucket_fold_plain,
        bucket_plan,
        bucket_sums,
        bucket_sums_plain,
        bucket_teams,
        fold_rounds,
        msm_bucket_rows,
        n_windows,
        window_digits,
    )
    from zkecdsa_tpu_torch.utils.profiling import kernel_device_ms

    curves = {"p256": (p256_ops, p256, MM_WEIER_ADD, MM_WEIER_DBL),
              "tomEdwards256": (tom_ops, tomEdwards256, MM_EDW_ADD, MM_EDW_DBL)}
    pb = NLIMBS * 4
    shapes: dict[str, list] = {}
    crossover = []

    def record(name, call, err, ms, plain_ms, bound, **extra):
        b, by = bound
        shapes.setdefault(name, []).append(dict(
            call=call, launches_per_call=1, launches_per_prove=0, max_abs_err=err,
            ms=ms, plain_ms=plain_ms, bound_ms=b, bound_by=by, **extra))

    def nibbles(scs, R, T):
        flat = [s for row in scs for s in row]
        return torch.from_numpy(nibble_digits(flat).astype(np.uint8).reshape(R, T, 64)).to(dev)

    def other_geometries(call, ops, plan, B, P, dig, w, rows, S_plain):
        """Each bucket_plan form the plan did not take, forced and held
        against the plain versions: the other lanes of bucket_sums (up to
        64 buckets), bucket_fold at 1, 2, 3 and twice the plan's segments
        (up to min(32, B - 1)), and at the other of one and two windows a
        team.  Returns ({form: ms}, err)."""
        ms, err = {}, 0
        if B <= 64:
            lanes = 5 - plan.lanes
            S2 = bucket_sums(ops, P, dig, w, lanes=lanes)
            err = max(err, _affine_exact(f"bucket_sums {call} lanes={lanes}", ops, S2[:rows], S_plain))
            ms[f"sums_lanes{lanes}"] = _cuda_ms(lambda: bucket_sums(ops, P, dig, w, lanes=lanes), 3)
        S = bucket_sums(ops, P, dig, w)
        want = bucket_fold_plain(ops, S[:rows], w)
        for segs in sorted({1, 2, 3, 2 * plan.segs} - {plan.segs}):
            if segs > min(32, B - 1):
                continue
            got = bucket_fold(ops, S, w, segs=segs, wpt=1)
            err = max(err, _affine_exact(f"bucket_fold {call} segs={segs}", ops, got[:rows], want))
            ms[f"fold_segs{segs}"] = _cuda_ms(lambda: bucket_fold(ops, S, w, segs=segs, wpt=1), 3)
        wpt = 3 - plan.wpt if plan.wpt <= 2 else 1
        got = bucket_fold(ops, S, w, segs=plan.segs, wpt=wpt)
        err = max(err, _affine_exact(f"bucket_fold {call} wpt={wpt}", ops, got[:rows], want))
        ms[f"fold_wpt{wpt}"] = _cuda_ms(lambda: bucket_fold(ops, S, w, segs=plan.segs, wpt=wpt), 3)
        return ms, err

    # -- the bucket kernels at path A's per-row shapes and the combined
    #    width; the plain bucket sums run on the first `rows` rows --------
    for name, R, T, w, rows in BUCKET:
        ops, g, mm_add, mm_dbl = curves[name]
        C, D, B = ops.NCOORD, n_windows(w), 1 << w
        P, scs = _msm_inputs(ops, g, R, T, rs, dev)
        dig = torch.from_numpy(window_digits(scs, T, w)).to(dev)
        call = f"{name} [{R}, {T}] w={w}"
        plan = bucket_plan(ops, R, w, bucket_teams(ops, dev))
        S = bucket_sums(ops, P, dig, w)
        plain, plain_ms = _once_ms(lambda: bucket_sums_plain(ops, P[:rows], dig[:rows], w))
        err = _affine_exact(f"bucket_sums {call}", ops, S[:rows], plain)
        ms = _cuda_ms(lambda: bucket_sums(ops, P, dig, w), 5)
        nnz = int((dig != 0).sum())
        # each nonempty bucket starts from its first term: the adds are the
        # nonzero digits less the nonempty buckets of nonzero digits
        flat = dig.reshape(R * D, T).long()
        counts = torch.zeros((R * D, B), dtype=torch.int64, device=dev).scatter_add_(1, flat, torch.ones_like(flat))
        nonempty = int((counts[:, 1:] > 0).sum())
        sums_bytes = R * T * C * pb + dig.numel() + R * D * B * C * pb
        bound = _no_looser(f"bucket_sums {call}", _bound(mm_add * (nnz - nonempty), sums_bytes),
                           _bound(mm_add * nnz, sums_bytes))
        # the tail: the top window holds 256 - (D-1)*w real bits, so few
        # buckets take many terms; time the call without it
        top = int(torch.bincount(dig[0, 0].long(), minlength=B)[1:].max())
        rest = dig.clone()
        rest[:, 0] = 0
        ms_rest = _cuda_ms(lambda: bucket_sums(ops, P, rest, w), 5)
        forms, err_forms = other_geometries(call, ops, plan, B, P, dig, w, rows, plain)
        record("bucket_sums", call, max(err, err_forms), ms, plain_ms, bound, plain_rows=rows,
               ms_top_window_zeroed=ms_rest, plan=dataclasses.asdict(plan),
               forced_ms={k: v for k, v in forms.items() if k.startswith("sums")})
        log(f"bucket_sums {call}: kernel {ms:.4f} ms ({plan.lanes} lane(s) a bucket), plain {plain_ms:.1f} ms "
            f"on [{rows}, {T}], exact (affine); {nnz} nonzero digits in {nonempty} nonempty buckets; {top} "
            f"terms in row 0's largest top-window bucket; {ms_rest:.4f} ms with the top window's digits "
            f"zeroed; forced: " + json.dumps({k: round(v, 4) for k, v in forms.items() if k.startswith("sums")}))
        out = bucket_fold(ops, S, w)
        plain, plain_ms = _once_ms(lambda: bucket_fold_plain(ops, S, w))
        err = _affine_exact(f"bucket_fold {call}", ops, out, plain)
        ms_fold = _cuda_ms(lambda: bucket_fold(ops, S, w), 5)
        rounds = fold_rounds(ops, w, plan)
        record("bucket_fold", call, max(err, err_forms), ms_fold, plain_ms,
               _bound(R * D * (2 * (B - 1) * mm_add + w * mm_dbl + mm_add), R * D * B * C * pb + R * C * pb),
               plan=dataclasses.asdict(plan), chain_team_rounds=rounds,
               forced_ms={k: v for k, v in forms.items() if k.startswith("fold")})
        log(f"bucket_fold {call}: kernel {ms_fold:.4f} ms ({plan.segs} segment(s) a window, {plan.wpt} "
            f"window(s) a team, {plan.groups} Horner groups, a chain of {rounds} team rounds), plain "
            f"{plain_ms:.1f} ms, exact (affine); "
            f"forced: " + json.dumps({k: round(v, 4) for k, v in forms.items() if k.startswith("fold")}))
        # the two kernels together against the Straus kernel, every row
        nib = nibbles(scs, R, T)
        _affine_exact(f"bucket vs straus_msm {call}", ops, out, straus_msm(ops, P, nib))
        if R * T <= 256 * 48:  # the public entry on host scalars, at the smallest shape
            _exact(f"msm_bucket_rows {call}", [(msm_bucket_rows(ops, P, scs, w), out)])
        ms_straus = _cuda_ms(lambda: straus_msm(ops, P, nib), 3)
        ms_bucket = _cuda_ms(lambda: bucket_fold(ops, bucket_sums(ops, P, dig, w), w), 3)
        crossover.append(dict(call=call, straus_ms=ms_straus, bucket_ms=ms_bucket))
        log(f"crossover {call}: straus_msm {ms_straus:.3f} ms, bucket_sums + bucket_fold "
            f"{ms_bucket:.3f} ms -> {'bucket' if ms_bucket < ms_straus else 'straus'} faster")

    # -- the skewed and empty cases, on the plan's and the forced geometries
    for name, R, T, w, rows in BUCKET_EDGE:
        ops, g, _, _ = curves[name]
        D, B = n_windows(w), 1 << w
        P, scs = _msm_inputs(ops, g, R, T, rs, dev)
        plan = bucket_plan(ops, R, w, bucket_teams(ops, dev))
        for case in BUCKET_EDGE_CASES:
            if case == "one_bucket":
                rows_s = [[row[5]] * T for row in scs]
            elif case == "top_window":
                tb = 256 - (D - 1) * w
                rows_s = [[(s >> (256 - tb)) << ((D - 1) * w) for s in row] for row in scs]
            else:
                rows_s = [[0] * T for _ in scs]
            dig = torch.from_numpy(window_digits(rows_s, T, w)).to(dev)
            call = f"{name} [{R}, {T}] w={w} {case}"
            S = bucket_sums(ops, P, dig, w)
            S_plain = bucket_sums_plain(ops, P[:rows], dig[:rows], w)
            err = _affine_exact(f"bucket_sums {call}", ops, S[:rows], S_plain)
            out = bucket_fold(ops, S, w)
            err = max(err, _affine_exact(f"bucket_fold {call}", ops, out[:rows],
                                         bucket_fold_plain(ops, S[:rows], w)))
            _affine_exact(f"bucket vs straus_msm {call}", ops, out, straus_msm(ops, P, nibbles(rows_s, R, T)))
            if case == "empty" and not bool(ops.is_identity(out).all()):
                raise AssertionError(f"bucket kernels {call}: an all-zero row is not the identity")
            forms, err_forms = other_geometries(call, ops, plan, B, P, dig, w, rows, S_plain)
            ms = _cuda_ms(lambda: bucket_sums(ops, P, dig, w), 3)
            ms_fold = _cuda_ms(lambda: bucket_fold(ops, S, w), 3)
            # the records ride on the first bucket_sums shape (no kernel of their own)
            shapes["bucket_sums"][0].setdefault("edge_cases", []).append(dict(
                call=call, max_abs_err=max(err, err_forms), sums_ms=ms, fold_ms=ms_fold,
                plan=dataclasses.asdict(plan), forced_ms=forms))
            log(f"bucket kernels {call}: exact (affine) on the plan's and the forced geometries; sums "
                f"{ms:.4f} ms, fold {ms_fold:.4f} ms; forced: "
                + json.dumps({k: round(v, 4) for k, v in forms.items()}))

    # -- msm_ladder on both curves, held against its plain version (the
    #    same order: exact) and against straus_msm (as group elements): at
    #    LADDER, then the edge rows at LADDER_EDGE's ragged shape and at
    #    T = 1; the kernel's device ms apart from its tree from one trace --
    traced = []
    for name, (ops, g, mm_add, mm_dbl) in curves.items():
        for R, T in (LADDER,) + LADDER_EDGE:
            edge = (R, T) != LADDER
            P, scs = (_ladder_edge_inputs if edge else _msm_inputs)(ops, g, R, T, rs, dev)
            bits = torch.from_numpy(scalar_bits([s for row in scs for s in row]).reshape(R, T, 256)).to(dev)
            call = f"{name} [{R}, {T}]" + (" (edge rows)" if edge else "")
            got = msm_ladder(ops, P, bits)
            plain, plain_ms = _once_ms(lambda: ops.msm_ladder(P, bits))
            err = _exact(f"msm_ladder {call}", [(got, plain)])
            _affine_exact(f"msm_ladder vs straus_msm {call}", ops, got, straus_msm(ops, P, nibbles(scs, R, T)))
            if edge and not bool(ops.is_identity(got[0])):
                raise AssertionError(f"msm_ladder {call}: the row of zero bits is not the identity")
            fn = functools.partial(msm_ladder, ops, P, bits)
            ms = _cuda_ms(fn, 3)
            record("msm_ladder", call + " (with its tree_sum tree)", err, ms, plain_ms,
                   _bound(R * T * 256 * (mm_dbl + mm_add), R * T * (ops.NCOORD * pb + 256) + R * ops.NCOORD * pb))
            traced.append((shapes["msm_ladder"][-1], fn))
    dms = kernel_device_ms([(fn, ["msm_ladder_kernel"], 1) for _, fn in traced], 3,
                           os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "trace"))
    for (rec, _), d in zip(traced, dms):
        rec["device_ms"] = d
        log(f"msm_ladder {rec['call']}: a team of four lanes a term: kernel {d:.4f} ms device (apart from its "
            f"tree), {rec['ms']:.3f} ms events with its tree; plain {rec['plain_ms']:.1f} ms; exact, = straus_msm")

    # -- straus_msm at path B's one-row shapes (msm: one proof's MultiMult),
    #    against the plain msm, the reference's per-term schedule ----------
    for name, T in SCALAR_MSM:
        ops, g, mm_add, mm_dbl = curves[name]
        P, scs = _msm_inputs(ops, g, 1, T, rs, dev)
        nib = nibbles(scs, 1, T)
        call = f"{name} [1, {T}] (msm, path B)"
        got = msm(ops, P[0], nib[0])
        plain, plain_ms = _once_ms(lambda: ops.msm(P[0], nib[0]))
        err = _affine_exact(f"straus_msm {call}", ops, got, plain)
        ms = _cuda_ms(lambda: msm(ops, P[0], nib[0]), 10)
        record("straus_msm", call, err, ms, plain_ms, _straus_bound(ops, P, nib),
               launches_per_scalar_proof=1,
               plan=dataclasses.asdict(straus_plan(1, T, straus_teams(ops, dev))))
        log(f"straus_msm {call}: {ms:.4f} ms with its tree_sum tree, plain msm {plain_ms:.1f} ms, exact (affine)")
    return shapes, crossover


def _word_mask(mask: int, p: int) -> int:
    """All-ones 32-bit words where ``mask`` has bits (word 0 = bit 0), mod p."""
    return sum(0xFFFFFFFF << (32 * w) for w in range(8) if (mask >> w) & 1) % p


def _mul_edges(f) -> list[tuple[int, int]]:
    """field_mul's edge rows: zeros, ones, p-1 and p-2 against each other,
    and for the P-256 prime 2^256 - 1 - p squared and the pairs that run
    the Solinas reduction's corrections every way (SOLINAS_MASKS)."""
    p = f.p
    edges = [(0, p - 1), (1, p - 1), (p - 1, p - 1), (p - 1, 0), (1, 1), (0, 0), (p - 2, p - 1)]
    if p == 2**256 - 2**224 + 2**192 + 2**96 - 1:  # P256_P, TOM_N
        edges.append((2**256 - 1 - p, 2**256 - 1 - p))
        edges += [(_word_mask(x, p), _word_mask(y, p)) for x, y in SOLINAS_MASKS]
    return edges


def check_field_kernels(dev, log) -> dict:
    """Phase 3, the mesh's field kernels, edge rows first, each exact
    against its plain version and against Python integers: ``field_mul``,
    plain and pair form, on the five moduli at FIELD_B rows (the row phase
    3 has always timed) and plain at the mesh's calls (``FIELD_MUL``); its chain
    form at ``sharded_gk_total``'s FIELD_CHAIN, beside the 12 plain
    launches it replaced; ``field_sum`` at the mesh's four calls
    (``FIELD_SUM``), a row summing p-1 D times.  Each record: ``ms`` (CUDA
    events over FIELD_REPS back-to-back calls, as every kernel's: at these
    sizes the wrapper's host rate), ``device_ms`` (the kernels' own time a
    call, from one ``torch.profiler`` trace of the same loops,
    ``utils.profiling.kernel_device_ms``), ``floor_ms`` (the empty kernel
    ``zk_noop`` at the call's grid, in the same trace), ``plan``, the
    bound (for the P-256 prime with the Solinas product's IMADs) and
    ``plain_ms``."""
    import numpy as np
    import torch

    from zkecdsa_tpu_torch import _build
    from zkecdsa_tpu_torch.ops.field import (
        NLIMBS,
        P256_N,
        P256_P,
        TOM_N,
        TOM_P,
        WAR_P,
        field_mul,
        field_mul_chain,
        field_mul_chain_plain,
        field_mul_plain,
        field_plan,
        field_sum,
        field_sum_plain,
    )
    from zkecdsa_tpu_torch.utils.profiling import kernel_device_ms

    rs = np.random.RandomState(SEED + 15)
    pb = NLIMBS * 4  # bytes per field element
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    lib = _build.load()
    stream = torch.cuda.current_stream(dev).cuda_stream
    traced = []  # (record, key, fn, kernel names, launches a call)
    grids = {}  # (blocks, threads) -> records whose floor it is

    def ints(f, n):
        return [int.from_bytes(rs.bytes(40), "little") % f.p for _ in range(n)]

    def record(name, call, kernel, plain, bound, grid, names, launches=1, **extra):
        got, rec = _case(name, call, kernel, plain, bound, FIELD_REPS, log, 0, launches)
        rec.update(extra, plan=dict(blocks=grid[0], threads=grid[1]))
        traced.append((rec, "device_ms", kernel, names, launches))
        grids.setdefault(grid, []).append(rec)
        return got, rec

    recs = {"field_mul": [], "field_sum": []}
    shapes = [(f, FIELD_B, "the row phase 3 has always timed") for f in (P256_P, P256_N, TOM_P, TOM_N, WAR_P)]
    shapes += [(TOM_N, B, use) for B, use in FIELD_MUL]
    for f, B, use in shapes:
        p = f.p
        edges = _mul_edges(f)
        ai = [x for x, _ in edges] + ints(f, B - len(edges))
        bi = [y for _, y in edges] + ints(f, B - len(edges))
        a, b = f.pack(ai, dev), f.pack(bi, dev)
        threads = field_plan(B, sms).threads
        grid = (-(-B // threads), threads)
        # the calls run again in the trace after the loop: bind this shape's operands
        got, rec = record("field_mul", f"{f.name} [{B}] (plain form; {use})",
                          lambda f=f, a=a, b=b: field_mul(f, a, b),
                          lambda: field_mul_plain(f, a, b), _field_bound(f, B, 3 * B * pb), grid,
                          ["field_mul_kernel"])
        if f.unpack(got[:1024]) != [x * y % p for x, y in zip(ai[:1024], bi[:1024])]:
            raise AssertionError(f"field_mul[{f.name}] [{B}] disagrees with Python integers")
        recs["field_mul"].append(rec)
        if B != FIELD_B:
            continue
        d, e = b.roll(1, 0), a.roll(3, 0)
        got, rec = record("field_mul", f"{f.name} [{B}] (pair form)",
                          lambda f=f, a=a, b=b, d=d, e=e: field_mul(f, a, b, d, e),
                          lambda: field_mul_plain(f, a, b, d, e), _field_bound(f, 2 * B, 5 * B * pb), grid,
                          ["field_mul_kernel"])
        di, ei = f.unpack(d[:1024]), f.unpack(e[:1024])
        if f.unpack(got[:1024]) != [(w * x + y * z) % p for w, x, y, z in zip(ai, bi, di, ei)]:
            raise AssertionError(f"field_mul[{f.name}] pair form disagrees with Python integers")
        recs["field_mul"].append(rec)

    # -- the chain form at sharded_gk_total's shape, beside its 12 launches --
    f, (R, n) = TOM_N, FIELD_CHAIN
    vi, fi = ints(f, R), ints(f, R * n)
    fi[:2], vi[:2] = [0, f.p - 1], [f.p - 1, 1]
    vals, fac = f.pack(vi, dev), f.pack(fi, dev).reshape(R, n, NLIMBS)

    def links():  # the parent's sharded_gk_total: n - 1 links, then the values
        prod = fac[:, 0]
        for j in range(1, n):
            prod = field_mul(f, prod, fac[:, j])
        return field_mul(f, vals, prod)

    threads = field_plan(R, sms).threads
    got, rec = record("field_mul", f"{f.name} chain [{R}] x {n} (5c: sharded_gk_total, one launch)",
                      lambda: field_mul_chain(f, vals, fac), lambda: field_mul_chain_plain(f, vals, fac),
                      _field_bound(f, R * n, (R * n + 2 * R) * pb), (-(-R // threads), threads),
                      ["field_chain_kernel"])
    want = []
    for r in range(R):
        acc = vi[r]
        for j in range(n):
            acc = acc * fi[r * n + j] % f.p
        want.append(acc)
    if f.unpack(got) != want:
        raise AssertionError("field_mul's chain form disagrees with Python integers")
    err = _exact(f"field_mul chain vs its {n} launches", [(links(), got)])
    rec.update(ms_links=_cuda_ms(links, FIELD_REPS), launches_links=n, max_abs_err=max(rec["max_abs_err"], err))
    traced.append((rec, "device_ms_links", links, ["field_mul_kernel"], n))
    recs["field_mul"].append(rec)

    # -- field_sum at the mesh's calls ---------------------------------------
    for D, R, use in FIELD_SUM:
        x = f.pack(ints(f, D * R), dev).reshape(D, R, -1)
        x[:, 0] = f.const(f.p - 1, dev)
        plan = field_plan(R, sms, D)
        grid = (R, plan.lanes) if plan.lanes > 1 else (-(-R // plan.threads), plan.threads)
        got, rec = record("field_sum", f"{f.name} [{D}, {R}] ({use})", lambda x=x: field_sum(f, x),
                          lambda: field_sum_plain(f, x), _bound(0, (D * R + R) * pb), grid,
                          ["field_sum_rows_kernel", "field_sum_block_kernel"], lanes=plan.lanes)
        xi = f.unpack(x[:, : min(R, 8)].transpose(0, 1))
        want = [sum(xi[r * D : (r + 1) * D]) % f.p for r in range(min(R, 8))]
        if f.unpack(got[:8]) != want or want[0] != (f.p - 1) * D % f.p:
            raise AssertionError("field_sum disagrees with Python integers")
        recs["field_sum"].append(rec)

    # -- device time: one trace of every case and the empty kernel at each
    #    case's grid ----------------------------------------------------------
    def noop(grid):
        return lambda: _build.check(lib.zk_noop(grid[0], grid[1], stream), "zk_noop")

    cases = [(fn, names, launches) for _, _, fn, names, launches in traced]
    cases += [(noop(g), ["noop_kernel"], 1) for g in grids]
    ms = kernel_device_ms(cases, FIELD_REPS, os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                                                          "trace"))
    for (rec, key, *_), t in zip(traced, ms):
        rec[key] = t
    for g, t in zip(grids, ms[len(traced):]):
        for rec in grids[g]:
            rec["floor_ms"] = t
    for name, rs_ in recs.items():
        for rec in rs_:
            log(f"{name} {rec['call']}: device {rec['device_ms']:.5f} ms, launch floor {rec['floor_ms']:.5f} ms "
                f"(grid {rec['plan']}), events {rec['ms']:.5f} ms, bound {rec['bound_ms']:.2e} ms ({rec['bound_by']})"
                + (f"; its {rec['launches_links']} launches: device {rec['device_ms_links']:.5f} ms, events "
                   f"{rec['ms_links']:.5f} ms" if "ms_links" in rec else ""))
    return recs


def _host_tables(params):
    """The comb tables of a parameter set from the Python-integer host
    oracle: (P-256 WeierComb of h, Tom-256 MixedComb of g then h), the
    Montgomery forms by ``FieldT.pack_mont``."""
    from zkecdsa_tpu_torch.ops.curve_ops import MixedComb, WeierComb, p256_ops
    from zkecdsa_tpu_torch.protocol.batch import DeviceParams

    pg = params.proof_group
    f = p256_ops.f
    host_n = DeviceParams._host_comb_weier(params.nist_group.h)
    return (WeierComb(host_n, f.pack_mont(f.unpack(host_n)).reshape(host_n.shape)),
            MixedComb.pack(DeviceParams._host_comb_mixed(pg.g) + DeviceParams._host_comb_mixed(pg.h)))


def _tables_exact(name: str, tabs, host) -> None:
    """A DeviceParams' tables against the host oracle's, exactly, in both
    forms."""
    host_n, host_t = host
    _exact(name, [(tabs["h_n8"].cpu(), host_n.canon), (tabs["comb_h_n8"].mont.cpu(), host_n.mont),
                  (tabs["gh_t8"].canon.cpu(), host_t.canon), (tabs["gh_t8"].mont.cpu(), host_t.mont)])


def check_setup_kernels(dev, params, log) -> tuple[dict, tuple]:
    """Phase 3, slice 7: ``comb8_bases`` and ``comb8_entries`` at the
    parameter set-up's shapes (the P-256 h, R = 1; the Tom-256 g and h,
    R = 2), each held exactly against its plain version on the card and
    against the host oracle.  The bound counts the least work of the
    algorithm: 248 doublings a base; 7 doublings and 254 additions a
    window, and for the affine step one batch inversion (3 products an
    entry and one inverse a call; the shipped inverse, a binary GCD,
    counts as its two conversions, the only products it makes) and the
    products of x, y (and of the rows x*y, d*x*y, a*x); the bases read,
    the tables written once.  Returns ({name: [shape record, ...]}, the
    host oracle's tables)."""
    import torch

    from zkecdsa_tpu_torch.ops.curve_ops import comb8_bases, comb8_entries, p256_ops, tom_ops
    from zkecdsa_tpu_torch.ops.field import NLIMBS

    pb = NLIMBS * 4
    t0 = time.perf_counter()
    host = _host_tables(params)
    host_s = time.perf_counter() - t0
    host_n, host_t = host
    shapes: dict[str, list] = {}
    pg = params.proof_group
    cases = (("P-256 h", p256_ops, [params.nist_group.h], MM_WEIER_ADD, MM_WEIER_DBL, 3 + 2),
             ("Tom-256 g, h", tom_ops, [pg.g, pg.h], MM_EDW_ADD, MM_EDW_DBL, 3 + 3 + 2))
    for what, ops, pts, mm_add, mm_dbl, mm_affine in cases:
        R, C = len(pts), ops.NCOORD
        P = ops.pack_points(pts, dev)
        call = f"{what}, [{R}] (DeviceParams)"
        bases, rec = _case("comb8_bases", call, lambda: comb8_bases(ops, P), lambda: ops.comb8_bases(P),
                           _bound(R * 31 * 8 * mm_dbl, R * C * pb + R * COMB_W * C * pb), 10, log, 0)
        # the host oracle: base j of each point is 2^(8j) * point, compared affine
        want = ops.pack_points([pt.mul(pt.group.new_scalar(1 << (8 * j))) for pt in pts for j in range(COMB_W)], dev)
        _affine_exact(f"comb8_bases {call} vs the host oracle", ops, bases.reshape(-1, C, NLIMBS), want)
        rec.update(launches_per_setup=1)
        shapes.setdefault("comb8_bases", []).append(rec)

        p = ops.f.p
        n_ent = R * COMB_W * COMB_E
        nc = tom_ops.MIXED_NC if ops is tom_ops else C
        chains = R * COMB_W * (7 * mm_dbl + 254 * mm_add)
        nbytes = R * COMB_W * C * pb + 2 * n_ent * nc * pb  # both forms written
        # mm_affine counts the batch inversion's 3 products an entry; the
        # inverse, fe_inv_vartime, makes two (from and to Montgomery form)
        bound = _no_looser(f"comb8_entries {what}",
                           _bound(chains + 3 * (n_ent - 1) + 2 + n_ent * (mm_affine - 3), nbytes),
                           _bound(chains + _batch_inv_mm(p, n_ent) + n_ent * (mm_affine - 3), nbytes))
        call = f"{what}, [{R}, {COMB_W}] window bases (DeviceParams)"
        got, rec = _case("comb8_entries", call, lambda: comb8_entries(ops, bases),
                         lambda: ops.comb8_entries(bases), bound, 10, log, 0)
        oracle = host_t if ops is tom_ops else host_n
        _exact(f"comb8_entries {call} vs the host oracle",
               [(got[0].reshape(oracle.canon.shape).cpu(), oracle.canon),
                (got[1].reshape(oracle.mont.shape).cpu(), oracle.mont)])
        rec.update(launches_per_setup=1)
        shapes.setdefault("comb8_entries", []).append(rec)
    log(f"comb8_bases, comb8_entries: exact against their plain versions and the host oracle "
        f"({host_s:.3f} s for the host oracle's tables)")
    return shapes, host


def _sharded_checks(mesh, dparams, log) -> dict:
    """Phase 5c in one rank: the sharded routines at full width against
    their unsharded counterparts on this rank (the same kernels on the
    whole input) and, for ``sharded_gk_total``, Python integers; inputs
    from one seed, the same on every rank.  Returns the seconds of each
    sharded call."""
    import numpy as np
    import torch

    from zkecdsa_tpu_torch.curves.instances import tomEdwards256 as g
    from zkecdsa_tpu_torch.ops.curve_ops import msm, tom_ops
    from zkecdsa_tpu_torch.ops.field import TOM_N, field_mul, field_sum
    from zkecdsa_tpu_torch.parallel.mesh import gather, sharded_commit, sharded_gk_total, sharded_msm

    rs = np.random.RandomState(SEED + 5)
    dev, q = mesh.device, TOM_N.p

    def ints(n):
        return [int.from_bytes(rs.bytes(40), "little") % q for _ in range(n)]

    def affine_equal(a, b):
        return all(torch.equal(x, y) for x, y in zip(tom_ops.to_affine(a), tom_ops.to_affine(b)))

    secs = {}

    def timed(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        secs[name] = time.perf_counter() - t0
        return out

    R, n = GK_TOTAL
    f_i, v_i = ints(R * n), ints(R)
    fac, vec = TOM_N.pack(f_i).reshape(R, n, -1), TOM_N.pack(v_i)
    field_mul.launches = field_sum.launches = 0
    got = timed("sharded_gk_total", lambda: sharded_gk_total(mesh, fac, vec))
    launches = (field_mul.launches, field_sum.launches)
    if launches != (1, 2):  # the chain form; the local sum and the partials'
        raise AssertionError(f"5c: sharded_gk_total made {launches} field_mul, field_sum launches, not (1, 2)")
    fd = fac.to(dev)
    prod = fd[:, 0]
    for j in range(1, n):
        prod = field_mul(TOM_N, prod, fd[:, j])
    want = field_sum(TOM_N, field_mul(TOM_N, vec.to(dev), prod)[:, None])[0]
    host = 0
    for i in range(R):
        p = v_i[i]
        for j in range(n):
            p = p * f_i[i * n + j] % q
        host = (host + p) % q
    if not torch.equal(got, want) or TOM_N.unpack(got) != [host]:
        raise AssertionError("5c: sharded_gk_total disagrees with the unsharded total")

    pool = [g.generator().mul(g.new_scalar(int.from_bytes(rs.bytes(32), "little") % g.order)) for _ in range(64)]
    pts = tom_ops.pack_points([pool[i % 64] for i in range(MESH_MSM_T)])
    dig = torch.from_numpy(rs.randint(0, 16, size=(MESH_MSM_T, 64)).astype(np.uint8))
    got = timed("sharded_msm", lambda: sharded_msm(mesh, tom_ops, pts, dig))
    if not affine_equal(got, msm(tom_ops, pts.to(dev), dig.to(dev))):
        raise AssertionError("5c: sharded_msm disagrees with the unsharded msm")

    vals, blinds = TOM_N.pack(ints(N)), TOM_N.pack(ints(N))
    got = timed("sharded_commit", lambda: gather(mesh, sharded_commit(mesh, dparams, vals, blinds)))
    if not affine_equal(got, dparams.commit_tom(vals.to(dev), blinds.to(dev))):
        raise AssertionError("5c: sharded_commit disagrees with commit_tom on the whole batch")
    log(f"5c: sharded_gk_total [{R}, {n}] ({launches[0]} field_mul launch, the chain form; {launches[1]} "
        f"field_sum), sharded_msm [{MESH_MSM_T}], sharded_commit [{N}] exact against their unsharded "
        f"counterparts; seconds {secs}")
    return secs


def _mesh_rank(rank: int, world: int, job: dict) -> dict:
    """Phase 5a or 5b in one rank: the mesh prove and verify of phase 4a's
    batch (a warm-up, then one run with the launch counts zeroed just
    before and read just after), their checks, the tampered batch, and
    phase 5c when ``job["checks"]``.  Raises on any failed check."""
    import torch
    import torch.distributed as dist

    from zkecdsa_tpu_torch.parallel.mesh import make_mesh_2d
    from zkecdsa_tpu_torch.protocol.batch import BatchProver, device_params_for
    from zkecdsa_tpu_torch.protocol.batch_verify import BatchVerifier
    from zkecdsa_tpu_torch.serde import read_json, write_json
    from zkecdsa_tpu_torch.utils import rng
    from zkecdsa_tpu_torch.zkp_attest_list import SignatureProofList, SystemParametersList

    def log(msg: str) -> None:
        print(f"[{job['name']} rank {rank}] {msg}", flush=True)

    torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    mesh = make_mesh_2d(*job["mesh"], backend=job["backend"])
    params = read_json(SystemParametersList, job["params"])
    fns = _kernel_fns()
    for fn in fns.values():
        fn.launches = 0
    t0 = time.perf_counter()
    dparams = device_params_for(params, mesh.device)
    dparams.tabs()
    torch.cuda.synchronize()
    params_s = time.perf_counter() - t0
    launches_setup = {k: fn.launches for k, fn in fns.items()}
    missing = [k for k in job["setup_path"] if launches_setup[k] <= 0]
    if missing:
        raise AssertionError(f"kernels not launched on the rank's set-up path: {missing}")
    bp, bv = BatchProver(params, mesh=mesh), BatchVerifier(params, mesh=mesh)

    def counted(what, run, path):
        run()
        torch.cuda.synchronize()
        for fn in fns.values():
            fn.launches = 0
        t0 = time.perf_counter()
        out = run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {k: fn.launches for k, fn in fns.items()}
        missing = [k for k in path if launches[k] <= 0]
        if missing:
            raise AssertionError(f"kernels not launched on the mesh {what} path: {missing}")
        return out, wall, launches

    def prove():
        tapes = [rng.DeterministicSource(SEED + 100 + i) for i in range(N)]
        return bp.prove(job["mhs"], job["sigs"], job["pubs"], list(range(N)), job["ring"], tapes)

    proofs, prove_s, launches_prove = counted("prove", prove, job["prove_path"])
    wire = [write_json(SignatureProofList, p) for p in proofs]
    sha = hashlib.sha256("".join(wire).encode()).hexdigest()
    if sha != job["sha256"]:
        raise AssertionError(f"the mesh proofs differ from phase 4a's (sha256 {sha})")
    ok, verify_s, launches_verify = counted(
        "verify", lambda: bv.verify(job["mhs"], job["ring"], proofs), job["verify_path"]
    )
    if ok != [True] * N:
        raise AssertionError(f"the mesh verify rejected honest proofs: {ok.count(False)} False")
    bad = read_json(SignatureProofList, wire[TAMPER_AT])
    bad.membershipProof.f[0] = bad.membershipProof.f[1]
    t0 = time.perf_counter()
    verdict = bv.verify(job["mhs"], job["ring"], proofs[:TAMPER_AT] + [bad] + proofs[TAMPER_AT + 1 :])
    tampered_s = time.perf_counter() - t0
    false_at = [i for i, v in enumerate(verdict) if not v]
    if false_at != [TAMPER_AT]:
        raise AssertionError(f"the mesh verify of the tampered batch: False at {false_at}")
    report = dict(
        rank=rank, coords=[mesh.coord("dp"), mesh.coord("ring")], device=str(mesh.device),
        backend=dist.get_backend(), device_params_s=params_s, prove_s=prove_s, verify_s=verify_s,
        tampered_s=tampered_s, sha256=sha, false_at=false_at, launches_setup=launches_setup,
        launches_prove=launches_prove, launches_verify=launches_verify,
    )
    log(json.dumps({k: v for k, v in report.items() if not k.startswith("launches")}))
    if job["checks"]:
        report["sharded_s"] = _sharded_checks(mesh, dparams, log)
    return report


# ---------------------------------------------------------------------------
# the trace of one prove and of one verify
# ---------------------------------------------------------------------------

# kernels whose launches are listed one by one, and the names of their
# __global__ functions where they are not <kernel>_kernel
TRACED = ("ec_add", "tree_sum", "window_table", "comb4_entries", "chord")
_GLOBALS = {"straus_msm": ("straus_kernel",)}


def _trace_run(what, run, check, shapes, path, per, log) -> dict:
    """One ``what`` (a prove or a verify) under ``utils.profiling.trace``
    (torch.profiler, CPU and CUDA activity; the Chrome trace in
    ``build/trace/``): the device's busy share of its wall; each kernel of
    ``path``'s device time in the trace beside phase 3's CUDA-event time
    for one run (ms x the records' ``per`` launches, summed over the
    shapes); and the device time of each launch of the ``TRACED``
    kernels, in order."""
    import torch

    from zkecdsa_tpu_torch.utils.profiling import device_time, kernel_launch_us, trace

    logdir = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "trace")
    with trace(logdir) as tr:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = run(None)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    check(out)
    busy_us, kernels = device_time(tr.path)
    if not kernels:
        log(f"trace: one {what} {wall:.3f} s; the trace holds no device kernel: device-busy share not measured")
        return dict(wall_s=wall, busy_ms=None, busy_share=None)
    names = sorted(set(path) | set(TRACED))
    launches = {k: [us / 1e3 for us in kernel_launch_us(kernels, _GLOBALS.get(k, (f"{k}_kernel",)))]
                for k in names}
    trace_ms = {k: sum(launches[k]) for k in path}
    event_ms = {k: sum(r["ms"] * r.get(per, 0) / r["launches_per_call"] for r in shapes[k]) for k in path}
    share = busy_us / 1e6 / wall
    all_ms = sum(us for _, _, us in kernels) / 1e3
    log(f"trace: one {what} {wall:.3f} s under the profiler; the device busy {busy_us / 1e3:.3f} ms "
        f"({100 * share:.3f}% of the wall); kernels {all_ms:.3f} ms, the port's {sum(trace_ms.values()):.3f} "
        f"ms (phase 3's events a {what} {sum(event_ms.values()):.3f} ms) ({tr.path})")
    for k in names:
        log(f"trace: {what}: {k} {sum(launches[k]):.4f} ms in {len(launches[k])} launches"
            + (f", phase 3's events a {what} {event_ms[k]:.4f} ms" if k in path else "")
            + (f"; each launch {[round(x, 4) for x in launches[k]]} ms" if k in TRACED else ""))
    return dict(wall_s=wall, busy_ms=busy_us / 1e3, busy_share=share, kernel_ms=all_ms,
                trace_ms=trace_ms, event_ms=event_ms, launches_ms={k: launches[k] for k in TRACED})


# ---------------------------------------------------------------------------
# main
# ---------------------------------------------------------------------------


def _stage_shares(path: str, timer, log) -> dict:
    """The hashing and tape stages of ``path`` (``HASHLIB_STAGES``):
    seconds a run (the timed reps' mean) and share of the stages' seconds,
    beside the share with hashlib and what it came to on that run's
    median wall."""
    wall0, shares0 = HASHLIB_STAGES[path]
    total = sum(timer.stages.values())
    out = {}
    for name, share0 in shares0.items():
        secs = timer.stages.get(name, 0.0) / REPS
        share = 100 * timer.stages.get(name, 0.0) / total
        out[name] = dict(s=secs, share=share, hashlib_share=share0)
        before = "not kept" if share0 is None else f"{share0:.1f}% (~{share0 * wall0 / 100:.3f} s)"
        log(f"stage {name}: {secs:.4f} s a {path}, {share:.2f}% of its stages; with hashlib: {before}")
    return out


def _card() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 2
    smi = _card()
    print(smi, flush=True)

    import numpy as np

    from zkecdsa_tpu_torch import _build, ecdsa
    from zkecdsa_tpu_torch.commit.pedersen import hash_to_point
    from zkecdsa_tpu_torch.ops.msm_bucket import bucket_fold, bucket_sums
    from zkecdsa_tpu_torch.protocol.batch import BatchProver, _device_params_cached, device_params_for
    from zkecdsa_tpu_torch.protocol.batch_verify import BatchVerifier
    from zkecdsa_tpu_torch.protocol.verify import device_msm_backend
    from zkecdsa_tpu_torch.runtime import native
    from zkecdsa_tpu_torch.serde import read_json, write_json
    from zkecdsa_tpu_torch.utils import rng
    from zkecdsa_tpu_torch.utils.config import get_config, set_config
    from zkecdsa_tpu_torch.utils.profiling import StageTimer
    from zkecdsa_tpu_torch.zkp_attest_list import (
        SignatureProofList,
        generate_params_list,
        verify_signature_list,
    )

    def log(msg: str) -> None:
        print(msg, flush=True)

    t_start = time.perf_counter()
    dev = torch.device(DEVICE)

    # -- phase 2: build (the kernels, and beside them the probe libraries
    #    that hold the chord and ec_add kernels their redesigns replaced) ----
    import threading

    from tools import torch_chord_probe, torch_ec_add_sweep

    probe_builds = [threading.Thread(target=m.build) for m in (torch_chord_probe, torch_ec_add_sweep)]
    for t in probe_builds:
        t.start()
    log(f"build: {native.build():.2f} s (g++, {native.LIB_PATH.name})")
    log(f"build: {_build.build():.1f} s (nvcc, sm_90a, {_build.LIB_PATH.name})")
    _build.load()
    for t in probe_builds:
        t.join()
    runtime_recs = check_runtime(np.random.RandomState(SEED + 5), log)

    # -- inputs, made from the seed: N signers whose keys open the ring;
    #    the host prover starts on proofs 0..K-1 in worker processes while
    #    the kernels are checked -------------------------------------------
    with rng.deterministic(SEED):
        params = generate_params_list()
        kps = [ecdsa.generate_keypair() for _ in range(N)]
    pubs = [ecdsa.export_public_raw(kp) for kp in kps]
    ring = [ecdsa.key_to_int(p) for p in pubs] + list(range(1000, 1000 + RING - N))
    msgs = [f"chip smoke message {i}".encode() for i in range(N)]
    mhs = [hashlib.sha256(m).digest() for m in msgs]
    with rng.deterministic(SEED + 1):
        sigs = [ecdsa.sign(kp, m) for kp, m in zip(kps, msgs)]
    params_json = write_json(type(params), params)
    # phase 4e's parameter set: both hardened modes on (h by hash-to-curve)
    cfg = get_config()
    set_config(dataclasses.replace(cfg, hardened_pedersen=1, hardened_gk=1))
    try:
        with rng.deterministic(SEED + 7):
            params_h = generate_params_list()
    finally:
        set_config(cfg)
    params_h_json = write_json(type(params_h), params_h)
    ctx = multiprocessing.get_context("spawn")
    workers = min(K, os.cpu_count() or 1)
    with ctx.Pool(workers) as pool:
        t0 = time.perf_counter()
        proving = pool.map_async(
            _prove_one,
            [(params_json, mhs[i], sigs[i], pubs[i], i, ring, SEED + 100 + i, 0) for i in range(K)],
        )
        proving_h = pool.map_async(
            _prove_one,
            [(params_h_json, mhs[i], sigs[i], pubs[i], i, ring, SEED + 100 + i, 1) for i in range(K_HARD)],
        )

        # -- phase 3: kernels against their plain versions, the set-up's
        #    first: every other check reads tables that they build --------
        shapes, host_tables = check_setup_kernels(dev, params, log)
        dparams = device_params_for(params, dev).tabs()
        rs = np.random.RandomState(SEED)
        for k, v in check_kernels(dev, dparams, rs, log).items():
            shapes.setdefault(k, []).extend(v if isinstance(v, list) else [v])
        for k, recs in check_prover_kernels(dev, dparams, rs, log).items():
            shapes.setdefault(k, []).extend(recs)
        msm_shapes, crossover = check_msm_kernels(dev, rs, log)
        for k, recs in msm_shapes.items():
            shapes.setdefault(k, []).extend(recs)
        shapes.update(check_field_kernels(dev, log))

        host_jsons = proving.get(timeout=900)
        log(f"host proving: {K} proofs at ring {RING} in {time.perf_counter() - t0:.1f} s "
            f"({workers} processes)")

        counters = _kernel_fns()
        setup_path = ("comb8_bases", "comb8_entries")
        prove_path = ("ring_fold", "ec_add", "window_table", "to_affine", "comb_mixed", "shamir",
                      "comb4_bases", "comb4_entries", "mul_comb4", "comb_weier", "chord")
        verify_path = ("ring_fold", "ec_add", "tree_sum", "to_affine", "straus_msm", "comb_mixed")
        bucket_path = verify_path + ("bucket_sums", "bucket_fold")  # path A
        scalar_path = ("straus_msm", "tree_sum")  # path B: msm, then its tree

        def zero_counts():
            for fn in counters.values():
                fn.launches = 0
            for fn in (bucket_sums, bucket_fold):
                fn.curves.clear()

        def read_counts():
            return {k: fn.launches for k, fn in counters.items()}

        def timed_reps(name, run, path, check):
            """One warm-up and REPS timed runs; the launch counts are set to
            0 just before the first timed run and read just after it."""
            t0 = time.perf_counter()
            out = run(None)
            torch.cuda.synchronize()
            log(f"{name} warm-up: {time.perf_counter() - t0:.2f} s")
            check(out)
            timer = StageTimer(dev)
            walls, launches = [], {}
            for rep in range(REPS):
                if rep == 0:
                    zero_counts()
                t0 = time.perf_counter()
                res = run(timer)
                torch.cuda.synchronize()
                walls.append(time.perf_counter() - t0)
                if rep == 0:
                    launches = read_counts()
                    curves = {fn.__name__: dict(fn.curves) for fn in (bucket_sums, bucket_fold)}
                check(res)
            wall = statistics.median(walls)
            log(f"slice: {name} N={N} ring={RING}: median {wall:.3f} s of "
                f"{[round(w, 3) for w in walls]} -> {N / wall:.2f} proofs/s on {smi}")
            log(f"{name} stages over the timed reps (seconds summed over reps):\n" + timer.report())
            log(f"launches in one {name}: " + json.dumps(launches) + f", bucket kernels by curve {curves}")
            missing = [k for k in path if launches[k] <= 0]
            if missing:
                raise AssertionError(f"kernels not launched on the {name} path: {missing}")
            return out, wall, launches, timer, curves

        def setup(what, prm):
            """DeviceParams of ``prm`` from a cold cache on the kernels:
            (its tables, seconds, launches), the launches counted from 0."""
            _device_params_cached.cache_clear()
            zero_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            tabs = device_params_for(prm, dev).tabs()
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            launches = read_counts()
            missing = [k for k in setup_path if launches[k] <= 0]
            if missing:
                raise AssertionError(f"kernels not launched on the {what} set-up path: {missing}")
            return tabs, secs, launches

        # -- phase 4, set-up: DeviceParams from a cold cache on the kernels,
        #    against the host oracle's seconds for the same tables ---------
        tabs, setup_s, launches_setup = setup("default", params)
        _tables_exact("DeviceParams (default) vs the host oracle", tabs, host_tables)
        for k in setup_path:
            at_shapes = sum(r["launches_per_setup"] for r in shapes[k])
            if at_shapes != launches_setup[k]:
                raise AssertionError(
                    f"{k}: {launches_setup[k]} launches in one set-up, {at_shapes} at the checked shapes"
                )
        t0 = time.perf_counter()
        _host_tables(params)
        host_setup_s = time.perf_counter() - t0
        log(f"setup: DeviceParams {setup_s:.4f} s from a cold cache on the kernels (launches "
            + json.dumps({k: launches_setup[k] for k in setup_path}) + f"), host oracle {host_setup_s:.3f} s "
            f"for the same tables, exact; on {smi}")

        # -- phase 4a: the prover --------------------------------------------
        bp = BatchProver(params, dev)

        def prove(timer):
            tapes = [rng.DeterministicSource(SEED + 100 + i) for i in range(N)]
            return bp.prove(mhs, sigs, pubs, list(range(N)), ring, tapes, timer=timer)

        wire: list[str] = []

        def check_proofs(proofs):
            got = [write_json(SignatureProofList, p) for p in proofs]
            if not wire:
                wire.extend(got)
                if got[:K] != host_jsons:
                    raise AssertionError("batched proofs 0..K-1 differ from the host prover's bytes")
                log(f"batched proofs 0..{K - 1} equal the host prover's byte for byte")
            elif got != wire:
                raise AssertionError("a timed prove gave other proof bytes than the warm-up")

        proofs, prove_wall, launches_prove, ptimer, _ = timed_reps(
            "prove", prove, prove_path, check_proofs
        )
        log("proof bytes sha256: " + hashlib.sha256("".join(wire).encode()).hexdigest())
        # phase 3 timed every shape of the prove path: its launches per
        # prove add up to the counts of the run
        for k in prove_path:
            at_shapes = sum(r["launches_per_prove"] for r in shapes[k])
            if at_shapes != launches_prove[k]:
                raise AssertionError(
                    f"{k}: {launches_prove[k]} launches in one prove, {at_shapes} at the checked shapes"
                )

        if launches_prove["field_mul"] != 0 or launches_prove["ring_fold"] != 1:
            raise AssertionError(f"a prove should make 1 ring_fold and 0 field_mul launches: {launches_prove}")
        traced = _trace_run("prove", prove, check_proofs, shapes, prove_path, "launches_per_prove", log)
        hash_stages = _stage_shares("prove", ptimer, log)

        # BatchProver.warmup(N): every kernel of the prove path launched
        # once, no randomness drawn; the prove after it launches as the
        # unwarmed timed rep did and gives its bytes
        zero_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        bp.warmup(N, ring=RING)
        warmup_s = time.perf_counter() - t0
        launches_warmup = read_counts()
        missing = [k for k in prove_path if launches_warmup[k] <= 0]
        if missing:
            raise AssertionError(f"kernels not launched by BatchProver.warmup: {missing}")
        zero_counts()
        check_proofs(prove(None))
        torch.cuda.synchronize()
        launches_after = read_counts()
        if launches_after != launches_prove:
            raise AssertionError(f"the prove after warmup launched {launches_after}, the unwarmed one {launches_prove}")
        log(f"BatchProver.warmup({N}, e=(56, 64), ring={RING}): {warmup_s:.3f} s (after phase 3: the kernels "
            f"loaded), launches " + json.dumps({k: launches_warmup[k] for k in prove_path})
            + f"; the prove after it: the unwarmed rep's launches and proof bytes; on {smi}")

        # -- phase 4b: the verifier on the N distinct proofs ------------------
        bv = BatchVerifier(params, dev)

        def check_verdicts(ok):
            if not all(ok):
                raise AssertionError(f"verify rejected honest proofs: {ok.count(False)} False")

        _, verify_wall, launches_verify, vtimer, _ = timed_reps(
            "verify", lambda timer: bv.verify(mhs, ring, proofs, timer=timer), verify_path,
            check_verdicts,
        )
        # phase 3 timed straus_msm, to_affine, ring_fold, ec_add and
        # tree_sum at every shape of the verify path: their launches per
        # verify add up to the counts of the run
        for k in ("straus_msm", "to_affine", "ring_fold", "ec_add", "tree_sum"):
            at_shapes = sum(r.get("launches_per_verify", 0) for r in shapes[k])
            if at_shapes != launches_verify[k]:
                raise AssertionError(
                    f"{k}: {launches_verify[k]} launches in one verify, {at_shapes} at the checked shapes"
                )
        if launches_verify["field_mul"] != 0 or launches_verify["ring_fold"] != 1:
            raise AssertionError(f"a verify should make 1 ring_fold and 0 field_mul launches: {launches_verify}")
        if vtimer.counts.get("msm.combine_host") != REPS or vtimer.counts.get("msm.pack_host") != REPS:
            raise AssertionError(
                f"expected the combined Tom-256 MSM and the per-row P-256 MSM once a rep: {vtimer.counts}"
            )
        vtraced = _trace_run("verify", lambda timer: bv.verify(mhs, ring, proofs, timer=timer), check_verdicts,
                             shapes, verify_path, "launches_per_verify", log)
        hash_stages.update(_stage_shares("verify", vtimer, log))
        both = prove_wall + verify_wall
        log(f"prove+verify: {both:.3f} s per batch of {N} -> {N / both:.2f} proofs/s on {smi}")

        # tampered GK response at one position: only it fails, through the
        # per-row attribution path
        bad = read_json(SignatureProofList, wire[TAMPER_AT])
        bad.membershipProof.f[0] = bad.membershipProof.f[1]
        tampered = list(proofs)
        tampered[TAMPER_AT] = bad
        ttimer = StageTimer(dev)
        t0 = time.perf_counter()
        verdict = bv.verify(mhs, ring, tampered, timer=ttimer)
        log(f"tampered batch: {time.perf_counter() - t0:.2f} s, False at "
            f"{[i for i, v in enumerate(verdict) if not v]}")
        if verdict != [i != TAMPER_AT for i in range(N)]:
            raise AssertionError("tampered batch: wrong verdicts")
        if ttimer.counts.get("msm.pack_host") != 2:
            raise AssertionError(f"the attribution path did not run: {ttimer.counts}")

        # -- phase 4c, path A: the verifier on the bucket backend -------------
        set_config(dataclasses.replace(cfg, pippenger_min_t=PIPPENGER_MIN_T))
        try:
            _, bucket_wall, launches_bucket, btimer, bcurves = timed_reps(
                "verify (bucket backend)", lambda timer: bv.verify(mhs, ring, proofs, timer=timer),
                bucket_path, check_verdicts,
            )
            # the honest batch's Tom-256 check stays on the combined Straus
            # MSM; its per-row P-256 MSM takes the bucket kernels
            if any(c.get("p256", 0) <= 0 for c in bcurves.values()):
                raise AssertionError(f"the P-256 per-row MSM did not take the bucket kernels: {bcurves}")
            zero_counts()
            t0 = time.perf_counter()
            verdict = bv.verify(mhs, ring, tampered)
            torch.cuda.synchronize()
            t_bad = time.perf_counter() - t0
            tcounts = read_counts()
            tcurves = {fn.__name__: dict(fn.curves) for fn in (bucket_sums, bucket_fold)}
        finally:
            set_config(cfg)
        log(f"tampered batch on the bucket backend: {t_bad:.2f} s, False at "
            f"{[i for i, v in enumerate(verdict) if not v]}; launches " + json.dumps(tcounts)
            + f", bucket kernels by curve {tcurves}")
        if verdict != [i != TAMPER_AT for i in range(N)]:
            raise AssertionError("tampered batch on the bucket backend: wrong verdicts")
        if any(c.get(g, 0) <= 0 for c in tcurves.values() for g in ("p256", "tomEdwards256")):
            raise AssertionError(f"the attribution MSMs did not take the bucket kernels on both curves: {tcurves}")
        log(f"verify: bucket backend {N / bucket_wall:.2f} proofs/s, Straus backend (phase 4b) "
            f"{N / verify_wall:.2f} proofs/s, on {smi}")

        # the host scalar verifier agrees on batched proofs and the
        # tampered one (each call timed in its worker)
        jobs = [(params_json, mhs[i], ring, wire[i], SEED + 200 + i) for i in range(K)]
        jobs.append((params_json, mhs[TAMPER_AT], ring,
                     write_json(SignatureProofList, bad), SEED + 300))
        host_res = pool.map(_host_verify, jobs)
        host_h_jsons = proving_h.get(timeout=900)
        pool.close()
        pool.join()
    host = [ok for ok, _ in host_res]
    host_s = [secs for _, secs in host_res]
    if host != [True] * K + [False]:
        raise AssertionError(f"host scalar verifier disagrees: {host}")
    log(f"host scalar verify_signature_list agrees: {host}; seconds per proof "
        f"{[round(x, 3) for x in host_s]}")

    # -- phase 4d, path B: the scalar verifier on the device MSM backend, in
    #    this process (the pool's workers never touch CUDA), one proof at a
    #    time; the counts are zeroed before each proof and read after it -----
    scalar_jobs = [(mhs[i], proofs[i], SEED + 200 + i) for i in range(K)]
    scalar_jobs.append((mhs[TAMPER_AT], bad, SEED + 300))
    dev_ok, dev_s, per_proof = [], [], []
    launches_scalar = dict.fromkeys(counters, 0)
    with device_msm_backend(dev):
        for mh, proof, seed in scalar_jobs:
            zero_counts()
            t0 = time.perf_counter()
            with rng.deterministic(seed):
                dev_ok.append(verify_signature_list(params, mh, ring, proof))
            torch.cuda.synchronize()
            dev_s.append(time.perf_counter() - t0)
            counts = read_counts()
            per_proof.append(counts["straus_msm"])
            for k, v in counts.items():
                launches_scalar[k] += v
    log(f"scalar verifier on the device MSM backend: {dev_ok}; straus_msm launches per proof "
        f"{per_proof}; seconds per proof {[round(x, 3) for x in dev_s]}")
    if dev_ok != host:
        raise AssertionError(f"the device MSM backend disagrees with the host verifier: {dev_ok}")
    if per_proof != [3] * K + [1]:
        raise AssertionError(f"expected 3 MSMs per honest proof and 1 for the tampered one: {per_proof}")
    missing = [k for k in scalar_path if launches_scalar[k] <= 0]
    if missing:
        raise AssertionError(f"kernels not launched on the scalar verifier's path: {missing}")
    dev_med, host_med = statistics.median(dev_s[:K]), statistics.median(host_s[:K])
    log(f"slice: scalar verify_signature_list at ring {RING}: median {dev_med:.3f} s per honest proof "
        f"on the device MSM backend, {host_med:.3f} s on the host, on {smi}")

    # -- phase 4e: the hardened configuration at full width: both flags on,
    #    a fresh parameter set (h by hash-to-curve on both curves), its
    #    DeviceParams on the kernels against the host oracle, one prove
    #    after a warm-up (proofs 0..K_HARD-1 against the host prover's bytes
    #    under the same flags, made in the pool), one verify, and the same
    #    batch verified with hardened_gk = 0: every proof False -----------
    set_config(dataclasses.replace(cfg, hardened_pedersen=1, hardened_gk=1))
    try:
        if not (params_h.proof_group.h.eq(hash_to_point(params_h.proof_group.c, params_h.proof_group.g.to_bytes()))
                and params_h.nist_group.h.eq(hash_to_point(params_h.nist_group.c, params_h.nist_group.g.to_bytes()))):
            raise AssertionError("4e: the hardened parameter set's h is not the hash-to-curve point of g")
        tabs_h, setup_h_s, launches_setup_h = setup("hardened", params_h)
        _tables_exact("DeviceParams (hardened) vs the host oracle", tabs_h, _host_tables(params_h))
        bph, bvh = BatchProver(params_h, dev), BatchVerifier(params_h, dev)

        def prove_h():
            tapes = [rng.DeterministicSource(SEED + 100 + i) for i in range(N)]
            return bph.prove(mhs, sigs, pubs, list(range(N)), ring, tapes)

        prove_h()
        torch.cuda.synchronize()
        zero_counts()
        t0 = time.perf_counter()
        proofs_h = prove_h()
        torch.cuda.synchronize()
        prove_h_s = time.perf_counter() - t0
        wire_h = [write_json(SignatureProofList, p) for p in proofs_h]
        if wire_h[:K_HARD] != host_h_jsons:
            raise AssertionError("4e: hardened batched proofs differ from the hardened host prover's bytes")
        if wire_h[0] == wire[0]:
            raise AssertionError("4e: the hardened proof equals the default one")
        t0 = time.perf_counter()
        ok_h = bvh.verify(mhs, ring, proofs_h)
        torch.cuda.synchronize()
        verify_h_s = time.perf_counter() - t0
        launches_hard = read_counts()  # the prove and the verify
        missing = [k for k in prove_path + verify_path if launches_hard[k] <= 0]
        if missing:
            raise AssertionError(f"kernels not launched on the hardened path: {missing}")
        if ok_h != [True] * N:
            raise AssertionError(f"4e: the hardened verify rejected honest proofs: {ok_h.count(False)} False")
        set_config(dataclasses.replace(cfg, hardened_pedersen=1, hardened_gk=0))
        ok_unbound = bvh.verify(mhs, ring, proofs_h)
        if any(ok_unbound):
            raise AssertionError(f"4e: hardened_gk = 0 accepted {ok_unbound.count(True)} hardened proofs")
    finally:
        set_config(cfg)
    for k in setup_path:
        launches_hard[k] = launches_setup_h[k]
    log(f"4e hardened (hardened_pedersen = hardened_gk = 1): DeviceParams {setup_h_s:.4f} s on the kernels, "
        f"exact against the host oracle; prove {prove_h_s:.3f} s ({N / prove_h_s:.2f} proofs/s), proofs "
        f"0..{K_HARD - 1} equal the hardened host prover's byte for byte; verify {verify_h_s:.3f} s "
        f"({N / verify_h_s:.2f} proofs/s), {N} x True; with hardened_gk = 0 {N} x False; on {smi}")

    # -- phase 4f: the batched example on the card, in a subprocess -------
    here = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    ex = subprocess.run(
        [sys.executable, os.path.join(here, "examples", "usage_batched_torch.py")], cwd=here,
        env=dict(os.environ, BATCH=str(EXAMPLE_BATCH), DEVICE=DEVICE, PYTHONPATH=here), capture_output=True, text=True,
        timeout=EXAMPLE_TIMEOUT,
    )
    example_s = time.perf_counter() - t0
    if ex.returncode != 0:
        raise AssertionError(f"examples/usage_batched_torch.py failed ({ex.returncode}):\n{ex.stderr[-3000:]}")
    log(f"4f examples/usage_batched_torch.py, BATCH={EXAMPLE_BATCH}: exit 0 in {example_s:.1f} s with the "
        f"interpreter's start:\n" + ex.stdout.rstrip())

    # -- phase 5: the mesh path, in spawned ranks (5a NCCL on one rank, 5b
    #    four gloo ranks sharing the card, with 5c in them) ------------------
    from zkecdsa_tpu_torch.parallel import launch

    proof_sha = hashlib.sha256("".join(wire).encode()).hexdigest()
    job = dict(params=params_json, mhs=mhs, sigs=sigs, pubs=pubs, ring=ring, sha256=proof_sha)
    mesh_runs = {}
    for name, backend, (dp, rg), checks in MESH_RUNS:
        # the ring-sharded GK routines add field_sum and, for the high index
        # bits, field_mul
        ring_path = ("field_sum", "field_mul") if rg > 1 else ()
        t0 = time.perf_counter()
        reports = launch.run(
            _mesh_rank, dp * rg, backend=backend, timeout=MESH_TIMEOUT,
            args=(dict(job, name=name, backend=backend, mesh=(dp, rg), checks=checks,
                       setup_path=setup_path, prove_path=prove_path + ring_path,
                       verify_path=verify_path + ring_path),),
        )
        mesh_runs[name] = reports
        walls = [(r["prove_s"], r["verify_s"]) for r in reports]
        log(f"{name}: mesh dp={dp} x ring={rg} over {backend}, {dp * rg} rank(s) on "
            f"{sorted({r['device'] for r in reports})}, {time.perf_counter() - t0:.1f} s with the spawn; "
            f"every rank: 4a's proof bytes (sha256 {proof_sha[:16]}...), {N} x True, tampered False at "
            f"{reports[0]['false_at']}")
        for r in reports:
            log(f"{name} rank {r['rank']} {r['coords']}: DeviceParams {r['device_params_s']:.3f} s on the "
                f"kernels ({r['launches_setup']['comb8_bases']} comb8_bases, "
                f"{r['launches_setup']['comb8_entries']} comb8_entries launches), prove "
                f"{r['prove_s']:.3f} s ({N / r['prove_s']:.2f} proofs/s), verify {r['verify_s']:.3f} s "
                f"({N / r['verify_s']:.2f} proofs/s), tampered batch {r['tampered_s']:.2f} s; launches "
                f"prove {json.dumps(r['launches_prove'])}, verify {json.dumps(r['launches_verify'])}")
        if rg > 1:  # the ring-sharded GK routines: one of each a rank a path
            for r in reports:
                for path in ("prove", "verify"):
                    got = [r[f"launches_{path}"][k] for k in ("field_mul", "field_sum")]
                    if got != [1, 1]:
                        raise AssertionError(f"{name} rank {r['rank']} {path}: field_mul, field_sum launches "
                                             f"{got}, not one each")
        p_s, v_s = max(w[0] for w in walls), max(w[1] for w in walls)
        log(f"slice: mesh {name} N={N} ring={RING}: prove {N / p_s:.2f} proofs/s, verify {N / v_s:.2f} "
            f"proofs/s (slowest rank) against unsharded {N / prove_wall:.2f} / {N / verify_wall:.2f} "
            f"(4a / 4b), on {smi}" + ("; four ranks share one card: no scaling figure" if dp * rg > 1 else ""))

    # -- phase 6: the kernels line and the result -----------------------------
    meta = {
        "field_mul": ("zkecdsa_tpu_torch/csrc/field.cu", "zkecdsa_tpu/ops/pallas_field.py:183"),
        "ring_fold": ("zkecdsa_tpu_torch/csrc/field.cu", "zkecdsa_tpu/protocol/batch_gk.py:66"),
        "ec_add": ("zkecdsa_tpu_torch/csrc/ec.cu", "zkecdsa_tpu/ops/pallas_field.py:214"),
        "tree_sum": ("zkecdsa_tpu_torch/csrc/ec.cu", "zkecdsa_tpu/ops/curve_ops.py:274"),
        "window_table": ("zkecdsa_tpu_torch/csrc/ec.cu", "zkecdsa_tpu/ops/curve_ops.py:133"),
        "to_affine": ("zkecdsa_tpu_torch/csrc/ec.cu", "zkecdsa_tpu/ops/curve_ops.py:459"),
        "straus_msm": ("zkecdsa_tpu_torch/csrc/msm.cu", "zkecdsa_tpu/ops/curve_ops.py:393"),
        "comb_mixed": ("zkecdsa_tpu_torch/csrc/comb.cu", "zkecdsa_tpu/ops/curve_ops.py:731"),
        "shamir": ("zkecdsa_tpu_torch/csrc/shamir.cu", "zkecdsa_tpu/ops/curve_ops.py:238"),
        "comb4_bases": ("zkecdsa_tpu_torch/csrc/comb4.cu", "zkecdsa_tpu/ops/curve_ops.py:194"),
        "comb4_entries": ("zkecdsa_tpu_torch/csrc/comb4.cu", "zkecdsa_tpu/ops/curve_ops.py:194"),
        "mul_comb4": ("zkecdsa_tpu_torch/csrc/comb4.cu", "zkecdsa_tpu/ops/curve_ops.py:218"),
        "comb_weier": ("zkecdsa_tpu_torch/csrc/comb.cu", "zkecdsa_tpu/ops/curve_ops.py:330"),
        "chord": ("zkecdsa_tpu_torch/csrc/chord.cu", "zkecdsa_tpu/ops/f32field.py:441"),
        "bucket_sums": ("zkecdsa_tpu_torch/csrc/bucket.cu", "zkecdsa_tpu/ops/msm_bucket.py:123"),
        "bucket_fold": ("zkecdsa_tpu_torch/csrc/bucket.cu", "zkecdsa_tpu/ops/msm_bucket.py:123"),
        "msm_ladder": ("zkecdsa_tpu_torch/csrc/ladder.cu", "zkecdsa_tpu/ops/curve_ops.py:373"),
        "field_sum": ("zkecdsa_tpu_torch/csrc/field.cu", "zkecdsa_tpu/parallel/mesh.py:130"),
        "comb8_bases": ("zkecdsa_tpu_torch/csrc/comb8.cu", "zkecdsa_tpu/ops/curve_ops.py:307"),
        "comb8_entries": ("zkecdsa_tpu_torch/csrc/comb8.cu", "zkecdsa_tpu/ops/curve_ops.py:666"),
    }
    kernels = []
    for name, (source, replaces) in meta.items():
        recs = shapes[name]
        e = recs[0]  # the first shape checked in phase 3
        prove_ms = sum(r["ms"] * r["launches_per_prove"] / r["launches_per_call"] for r in recs)
        mesh_launches = {
            run: {path: [r[f"launches_{path}"][name] for r in reports] for path in ("setup", "prove", "verify")}
            for run, reports in mesh_runs.items()
        }
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": (launches_setup[name] + launches_prove[name] + launches_verify[name]
                         + launches_bucket[name] + launches_scalar[name] + launches_hard[name]
                         + sum(sum(v) for m in mesh_launches.values() for v in m.values())),
            "launches_setup": launches_setup[name],
            "launches_prove": launches_prove[name], "launches_verify": launches_verify[name],
            "launches_hardened": launches_hard[name],
            "launches_bucket_verify": launches_bucket[name],
            "launches_scalar_verify": launches_scalar[name],
            "launches_mesh": mesh_launches,
            "max_abs_err": max(r["max_abs_err"] for r in recs),
            "ms": e["ms"], "plain_ms": e["plain_ms"], "bound_ms": e["bound_ms"],
            "bound_by": e["bound_by"], "library_ms": None, "call": e["call"],
            "prove_ms": prove_ms, "shapes": recs,
        })
        log(f"{name}: {prove_ms:.4f} ms of kernel time in one prove "
            f"({launches_prove[name]} launches)")
    log(f"total: {time.perf_counter() - t_start:.1f} s")
    print(smi)
    print(json.dumps({
        "kernels": kernels,
        "setup_s": setup_s, "host_setup_s": host_setup_s, "hardened_setup_s": setup_h_s,
        "hardened_prove_s": prove_h_s, "hardened_verify_s": verify_h_s,
        "prove_s": prove_wall, "prove_proofs_per_s": N / prove_wall,
        "verify_s": verify_wall, "verify_proofs_per_s": N / verify_wall,
        "prove_verify_proofs_per_s": N / both,
        "bucket_verify_s": bucket_wall, "bucket_verify_proofs_per_s": N / bucket_wall,
        "scalar_verify_s_per_proof": dev_med, "host_scalar_verify_s_per_proof": host_med,
        "crossover": crossover,
        "prove_stages": ptimer.stages, "verify_stages": vtimer.stages, "prove_trace": traced, "verify_trace": vtraced,
        "bucket_verify_stages": btimer.stages,
        "runtime_hash": runtime_recs, "hash_stages": hash_stages, "warmup_s": warmup_s,
        "example_s": example_s,
        "mesh": {run: [{k: v for k, v in r.items() if not k.startswith("launches")} for r in reports]
                 for run, reports in mesh_runs.items()},
    }))
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
