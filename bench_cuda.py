"""Benchmark entry point of the PyTorch port: ``bench.py``'s contract
(prints ONE JSON line) on ``zkecdsa_tpu_torch`` and one NVIDIA card.

Measures batched ZKAttest prove+verify throughput: ``BatchProver.prove``
then ``BatchVerifier.verify`` on B distinct instances over a ring of RING
keys, the median of the timed reps' walls (host clock, ending in
``torch.cuda.synchronize()``).  ``vs_baseline`` is against the port's
host scalar prover and verifier (``prove_signature_list`` /
``verify_signature_list``), the stand-in for the reference TypeScript
implementation, as in bench.py.

    python3 bench_cuda.py

Env knobs, bench.py's: BENCH_BATCH (default 256), BENCH_RING (default
4096), BENCH_HOST_REPS (default 1), BENCH_PROVE_ONLY=1 to skip the batched
verifier, BENCH_REPS (default 3, at least 2), BENCH_WARMUP (default 1:
``BatchProver.warmup`` launches every kernel of a prove once before the
timed reps; 0 runs one untimed prove and verify instead).  BENCH_DEVICE
(default cuda; ``cpu`` runs the plain PyTorch versions, for a rehearsal at
a small batch).  Every timed rep proves on fresh tapes (seeds no earlier
rep used).  The ``StageTimer`` report of the timed reps goes to stderr,
with the card's name and power limit.
"""

import json
import os
import subprocess
import sys
import time


def _card() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True,
        ).stdout.strip().splitlines()[0]
    except (OSError, subprocess.CalledProcessError, IndexError):
        return "nvidia-smi not available"


def main() -> None:
    import hashlib
    import statistics

    import torch

    from zkecdsa_tpu_torch import ecdsa
    from zkecdsa_tpu_torch.protocol.batch import BatchProver, resolve_device
    from zkecdsa_tpu_torch.protocol.batch_verify import BatchVerifier
    from zkecdsa_tpu_torch.runtime import native
    from zkecdsa_tpu_torch.utils import rng
    from zkecdsa_tpu_torch.utils.profiling import StageTimer
    from zkecdsa_tpu_torch.zkp_attest_list import (
        generate_params_list,
        prove_signature_list,
        verify_signature_list,
    )

    B = int(os.environ.get("BENCH_BATCH", "256"))
    RING = int(os.environ.get("BENCH_RING", "4096"))
    HOST_REPS = int(os.environ.get("BENCH_HOST_REPS", "1"))
    PROVE_ONLY = os.environ.get("BENCH_PROVE_ONLY", "") == "1"
    REPS = max(2, int(os.environ.get("BENCH_REPS", "3")))
    WARMUP = os.environ.get("BENCH_WARMUP", "1") == "1"
    dev = resolve_device(os.environ.get("BENCH_DEVICE") or None)
    cuda = dev.type == "cuda"
    where = f"{_card()} ({torch.cuda.get_device_name(dev)})" if cuda else "cpu"
    print(f"# device: {where}; native runtime: {native.available()}", file=sys.stderr)

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    with rng.deterministic(42):
        params = generate_params_list()
        # RING keypairs' worth of ring: instance i signs under keypair
        # i % RING, whose key sits at ring slot whichs[i]
        kps = [ecdsa.generate_keypair() for _ in range(min(B, RING))]
        ring = [
            ecdsa.key_to_int(ecdsa.export_public_raw(kp)) for kp in kps
        ] + list(range(1000, 1000 + max(0, RING - B)))
        msgs, sigs, pubs, whichs = [], [], [], []
        for i in range(B):
            kp = kps[i % len(kps)]
            msg = f"bench message {i}".encode()
            sigs.append(ecdsa.sign(kp, msg))
            pubs.append(ecdsa.export_public_raw(kp))
            msgs.append(hashlib.sha256(msg).digest())
            whichs.append(i % len(kps))

    # baseline: the port's host scalar prover + verifier
    t0 = time.perf_counter()
    for i in range(HOST_REPS):
        with rng.deterministic(7 + i):
            host_proof = prove_signature_list(
                params, msgs[i % B], sigs[i % B], pubs[i % B], whichs[i % B], ring
            )
    host_prove = (time.perf_counter() - t0) / HOST_REPS
    t0 = time.perf_counter()
    for i in range(HOST_REPS):
        assert verify_signature_list(params, msgs[(HOST_REPS - 1) % B], ring, host_proof)
    host_verify = (time.perf_counter() - t0) / HOST_REPS
    host_per_op = host_prove + (0.0 if PROVE_ONLY else host_verify)
    print(f"# host scalar: prove {host_prove:.2f} s, verify {host_verify:.2f} s", file=sys.stderr)

    t0 = time.perf_counter()
    prover = BatchProver(params, dev)
    verifier = None if PROVE_ONLY else BatchVerifier(params, dev)
    sync()
    print(f"# set-up (DeviceParams): {time.perf_counter() - t0:.3f} s", file=sys.stderr)

    def run(seed_base, timer=None):
        tapes = [rng.DeterministicSource(seed_base + i) for i in range(B)]
        proofs = prover.prove(msgs, sigs, pubs, whichs, ring, tapes, timer=timer)
        sync()
        return proofs

    def check(proofs, timer=None):
        if verifier is None:
            assert verify_signature_list(params, msgs[0], ring, proofs[0]), "bench proof invalid"
            return
        ok = verifier.verify(msgs, ring, proofs, timer=timer)
        sync()
        assert all(ok), f"batched verify failed: {ok.count(False)} False"

    t0 = time.perf_counter()
    if WARMUP:
        prover.warmup(B, ring=len(ring))
        print(f"# BatchProver.warmup({B}): {time.perf_counter() - t0:.3f} s", file=sys.stderr)
    else:
        check(run(10_000))
        print(f"# untimed prove+verify: {time.perf_counter() - t0:.2f} s", file=sys.stderr)

    timer = StageTimer(dev)
    walls = []
    for rep in range(REPS):
        t0 = time.perf_counter()
        proofs = run(20_000 + rep * B, timer)  # fresh tapes every rep
        t_prove = time.perf_counter() - t0
        print(f"# batched prove: {t_prove:.3f} s for {B} proofs", file=sys.stderr)
        t_verify = 0.0
        if verifier is not None:
            t0 = time.perf_counter()
            check(proofs, timer)
            t_verify = time.perf_counter() - t0
            print(f"# batched verify: {t_verify:.3f} s for {B} proofs", file=sys.stderr)
        walls.append(t_prove + t_verify)
    print(f"# stages over {REPS} reps on {where}:\n" + timer.report(), file=sys.stderr)

    throughput = B / statistics.median(walls)
    print(json.dumps({
        "metric": "zkattest_prove_throughput" if PROVE_ONLY else "zkattest_prove_verify_throughput",
        "value": round(throughput, 4),
        "unit": "proofs/sec",
        "vs_baseline": round(throughput * host_per_op, 4),
    }))


if __name__ == "__main__":
    main()
