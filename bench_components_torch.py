"""Per-component benchmark of the PyTorch port: the counterpart of
bench_components.py (reference bench/curves/ec.bench.ts:34-53,
bench/exp/exp.bench.ts:43-59, bench/proofGK/gk.bench.ts:31-47,
bench/commit/*.bench.ts, bench/zkpAttestList.bench.ts:46 proof-size
printouts, bench/hrtime.ts).

Prints one line per component: name, ns/op (and ops/s), and for proofs
the JSON wire size.  The device rows run the port's CUDA kernels on the
card (``CB_DEVICE``, default cuda; ``cpu`` runs their plain versions),
timed with CUDA events (``utils.profiling.kernel_ns_per_op``) on the card
and with the host clock on the CPU; the host rows run the host scalar
layer.  The port has no kernel of its own for a point doubling (it runs
inside the other kernels), so there is no ``ec/dbl`` row;
``field/batch_inv`` is ``to_affine``'s batch inversion.

    python3 bench_components_torch.py

Env knobs, as bench_components.py's: CB_DEVICE_BATCH (default 4096) -
the batch amortizing launch overhead; CB_RINGS (default "8,1024") - GK
ring sizes; CB_GK_BATCH (default 64) - instances of the device GK rows;
CB_FAST=1 skips the host prove/verify end-to-end rows.
"""

import hashlib
import os
import time


def timeit(fn, reps, *args):
    fn(*args)  # warm
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn(*args)
    dt = (time.perf_counter() - t0) / reps
    return out, dt


def row(name, ns_per_op, extra=""):
    ops = 1e9 / ns_per_op if ns_per_op else 0.0
    print(f"{name:<38} {ns_per_op:>14,.0f} ns/op {ops:>14,.1f} ops/s  {extra}", flush=True)


def main() -> None:
    import numpy as np
    import torch

    from zkecdsa_tpu_torch import ecdsa
    from zkecdsa_tpu_torch.bignum import big
    from zkecdsa_tpu_torch.commit.pedersen import generate_pedersen_params
    from zkecdsa_tpu_torch.curves.instances import p256, tomEdwards256, war256
    from zkecdsa_tpu_torch.ops.curve_ops import ec_add, nibble_digits, p256_ops, straus_msm, to_affine, tom_ops
    from zkecdsa_tpu_torch.ops.field import P256_P, TOM_N, field_mul
    from zkecdsa_tpu_torch.ops.msm_bucket import msm_bucket_rows
    from zkecdsa_tpu_torch.proofGK.gk import prove_membership, verify_membership
    from zkecdsa_tpu_torch.protocol.batch import device_params_for, resolve_device
    from zkecdsa_tpu_torch.protocol.batch_gk import gk_dvalues_device, gk_recombine_device
    from zkecdsa_tpu_torch.runtime import native
    from zkecdsa_tpu_torch.serde import read_json, write_json
    from zkecdsa_tpu_torch.utils import rng
    from zkecdsa_tpu_torch.utils.profiling import kernel_ns_per_op
    from zkecdsa_tpu_torch.zkp_attest_list import (
        SignatureProofList,
        generate_params_list,
        prove_signature_list,
        verify_signature_list,
    )

    B = int(os.environ.get("CB_DEVICE_BATCH", "4096"))
    rings = [int(r) for r in os.environ.get("CB_RINGS", "8,1024").split(",")]
    fast = os.environ.get("CB_FAST", "") == "1"
    dev = resolve_device(os.environ.get("CB_DEVICE") or None)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"# device: {dev} ({name})   batch {B}   native runtime: {native.available()}")
    rs = np.random.RandomState(7)

    def device_ns(fn, args, n_ops, reps):
        """ns per op of fn(*args) on ``dev``: CUDA events on the card, the
        host clock (ending in the result) on the CPU."""
        if dev.type == "cuda":
            return kernel_ns_per_op(fn, args, n_ops, iters=reps)
        _, dt = timeit(fn, reps, *args)
        return dt * 1e9 / n_ops

    def ints(n, nbytes=31):
        return [int.from_bytes(rs.bytes(nbytes), "big") for _ in range(n)]

    # ---- field engine (bignum analog of bench/bignum/big.bench.ts) ----
    a = P256_P.pack(ints(B), dev)
    b = P256_P.pack(ints(B), dev)
    row("field/mulmod-256 (batched)", device_ns(lambda: field_mul(P256_P, a, b), (), B, 20))

    # ---- curve kernels (ec.bench.ts:34-53 / hrtime.ts analog) ----
    for g, ops in ((p256, p256_ops), (tomEdwards256, tom_ops)):
        G = g.generator()
        pts = [G.mul(g.new_scalar(k + 2)) for k in range(64)]
        P = ops.pack_points((pts * ((B // 64) + 1))[:B], dev)
        Q = torch.roll(P, 7, dims=0)
        row(f"{g.name}/ec/add (batched)", device_ns(lambda: ec_add(ops, P, Q), (), B, 20))
        if g is p256:
            row("field/batch_inv (to_affine)", device_ns(lambda: to_affine(ops, P), (), B, 5))
        SB = max(B // 16, 1)
        digs = torch.from_numpy(nibble_digits(ints(SB, 32)).astype(np.uint8)).to(dev)[:, None]
        Ps = P[:SB, None]
        row(f"{g.name}/ec/mul (batched)", device_ns(lambda: straus_msm(ops, Ps, digs), (), SB, 3))
        # host scalar mul (the reference's actual op shape, hrtime.ts)
        s = g.new_scalar(int.from_bytes(rs.bytes(32), "big"))
        _, dt = timeit(lambda: G.mul(s), 20)
        row(f"{g.name}/ec/mul (host scalar)", dt * 1e9)

    # ---- MSM backends (multimult.ts:61-145 replacement): Straus vs
    # Pippenger buckets, one row of T terms ----
    g = tomEdwards256
    G = g.generator()
    for T in (64, 512, 4096):
        pts = [G.mul(g.new_scalar(k + 2)) for k in range(T)]
        scs = ints(T, 32)
        P = tom_ops.pack_points(pts, dev)[None]
        D = torch.from_numpy(nibble_digits(scs).astype(np.uint8)).to(dev)[None]
        ns = device_ns(lambda: straus_msm(tom_ops, P, D), (), T, 3)
        row(f"msm straus T={T}", ns, f"({ns * T / 1e6:.3f} ms/msm)")
        ns = device_ns(lambda: msm_bucket_rows(tom_ops, P, [scs]), (), T, 3)
        row(f"msm bucket T={T}", ns, f"({ns * T / 1e6:.3f} ms/msm)")

    # ---- Pedersen commit (pedersen.bench.ts:26-28) ----
    with rng.deterministic(3):
        pp = generate_pedersen_params(tomEdwards256)
    with rng.deterministic(4):
        params = generate_params_list()
    dp = device_params_for(params, dev)
    vals, blinds = TOM_N.pack(ints(B), dev), TOM_N.pack(ints(B), dev)
    row("pedersen/commit (batched device)", device_ns(lambda: dp.commit_tom(vals, blinds), (), B, 5))
    _, dt = timeit(lambda: pp.commit(12345), 10)
    row("pedersen/commit (host scalar)", dt * 1e9)

    # ---- GK membership by ring size (gk.bench.ts:31-47) ----
    for R in rings:
        keys = [3 + 2 * i for i in range(R)]
        with rng.deterministic(5):
            com = pp.commit(keys[1])
            gkp, dt = timeit(lambda: prove_membership(pp, com, 1, keys), 1)
        row(f"gk/prove ring={R} (host)", dt * 1e9)
        _, dt = timeit(lambda: verify_membership(pp, com.p, keys, gkp), 1)
        row(f"gk/verify ring={R} (host)", dt * 1e9)

    # ---- device GK by ring size: the d-polynomial evaluation and the ring
    # recombination on ring_fold (gk.ts:135-171, 239-250) ----
    NGK = int(os.environ.get("CB_GK_BATCH", "64"))
    for R in rings:
        RING = 1 << max(1, (R - 1).bit_length())
        n = (RING - 1).bit_length()
        values = [3 + 2 * i for i in range(RING)]
        eli = rs.randint(0, 2, (NGK, n)).tolist()
        ai = [ints(n) for _ in range(NGK)]
        vidx = ints(NGK)
        _, dt = timeit(lambda: gk_dvalues_device(eli, ai, values, vidx, dev), 3)
        row(f"gk/dvalues ring={RING} batch={NGK} (device)", dt * 1e9 / NGK, f"({dt * 1e3:.1f} ms/batch)")
        f_a = TOM_N.pack(ints(NGK * n), dev).reshape(NGK, n, -1)
        vals_d = TOM_N.pack(values, dev)
        ns = device_ns(lambda: gk_recombine_device(f_a, f_a, vals_d), (), NGK, 3)
        row(f"gk/recombine ring={RING} batch={NGK} (device)", ns, f"({ns * NGK / 1e6:.3f} ms/batch)")

    # ---- host runtime: SHA-256 on the thread pool (the DRBG's blocks) ----
    blocks = np.frombuffer(rs.bytes(40 * 65536), np.uint8).reshape(65536, 40)
    _, dt = timeit(lambda: native.sha256_rows(blocks), 5)
    row("runtime/sha256_rows [65536, 40]", dt * 1e9 / 65536)
    _, dt = timeit(lambda: [hashlib.sha256(r.tobytes()).digest() for r in blocks], 1)
    row("runtime/hashlib [65536, 40]", dt * 1e9 / 65536)

    if not fast:
        # ---- end-to-end + serde + sizes (zkpAttestList.bench.ts) ----
        with rng.deterministic(6):
            kp = ecdsa.generate_keypair()
            msg = b"component bench"
            sig = ecdsa.sign(kp, msg)
            pub = ecdsa.export_public_raw(kp)
            mh = hashlib.sha256(msg).digest()
            ring = [ecdsa.key_to_int(pub)] + [5 + i for i in range(7)]
        proof, dt = timeit(lambda: prove_signature_list(params, mh, sig, pub, 0, ring), 1)
        row("zkattest/prove (host scalar)", dt * 1e9)
        _, dt = timeit(lambda: verify_signature_list(params, mh, ring, proof), 1)
        row("zkattest/verify (host scalar)", dt * 1e9)
        js, dt = timeit(lambda: write_json(SignatureProofList, proof), 5)
        row("zkattest/toJson", dt * 1e9, f"proof size {len(js)} bytes")
        _, dt = timeit(lambda: read_json(SignatureProofList, js), 5)
        row("zkattest/fromJson", dt * 1e9)

    # ---- bignum host (big.bench.ts:22-26) ----
    _, dt = timeit(lambda: big.is_prime(war256.p), 5)
    row("big/isPrime (war256 modulus)", dt * 1e9)


if __name__ == "__main__":
    main()
