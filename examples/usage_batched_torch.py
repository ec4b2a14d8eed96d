"""Batched ZKAttest on the PyTorch port's device pipeline: the counterpart
of examples/usage_batched.py.

Proves a batch of independent signatures under one ring with
``BatchProver`` (the phases on the CUDA kernels), then verifies the whole
batch with ``BatchVerifier``.  Compare examples/usage_torch.py (the host
scalar path).

    python examples/usage_batched_torch.py               # on the card
    DEVICE=cpu python examples/usage_batched_torch.py    # the plain PyTorch versions
    python examples/usage_batched_torch.py --device cpu

BATCH sets the batch (default 4).  Without a card the default device
raises: nothing falls back to the CPU unless asked.
"""

import argparse
import hashlib
import os
import time

from zkecdsa_tpu_torch import ecdsa, generate_params_list, key_to_int
from zkecdsa_tpu_torch.protocol import BatchProver, BatchVerifier
from zkecdsa_tpu_torch.serde import write_json
from zkecdsa_tpu_torch.zkp_attest_list import SignatureProofList


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=os.environ.get("DEVICE") or None,
                    help="torch device (default: cuda; 'cpu' runs the plain versions)")
    device = ap.parse_args().device
    B = int(os.environ.get("BATCH", "4"))

    msgs, sigs, pubs, whichs, ring = [], [], [], [], []
    for i in range(B):
        kp = ecdsa.generate_keypair()
        msg = f"message number {i}".encode()
        sigs.append(ecdsa.sign(kp, msg))
        pub = ecdsa.export_public_raw(kp)
        msgs.append(hashlib.sha256(msg).digest())
        pubs.append(pub)
        ring.append(key_to_int(pub))
        whichs.append(i)
    ring += [4, 5, 6, 7]  # extra decoy keys

    params = generate_params_list()
    t0 = time.perf_counter()
    prover = BatchProver(params, device)
    verifier = BatchVerifier(params, device)
    print(f"device: {prover.device}  batch: {B}  ring: {len(ring)}  "
          f"(set-up {time.perf_counter() - t0:.2f}s)")
    t0 = time.perf_counter()
    proofs = prover.prove(msgs, sigs, pubs, whichs, ring)
    t1 = time.perf_counter()
    print(f"batched prove: {t1 - t0:.2f}s for {B} proofs "
          f"({B / (t1 - t0):.2f} proofs/sec incl. the first launches)")
    print(f"proof size: {len(write_json(SignatureProofList, proofs[0]))} bytes")

    t0 = time.perf_counter()
    oks = verifier.verify(msgs, ring, proofs)
    t1 = time.perf_counter()
    print(f"batched verify: {t1 - t0:.2f}s -> {oks}")
    assert all(oks)


if __name__ == "__main__":
    main()
