"""End-to-end ZKAttest walkthrough on the PyTorch port's host layer: the
counterpart of examples/usage.py (reference example/usage.ts).

Sign a message with ECDSA-P256, place the public key in a ring, produce a
zero-knowledge proof that the signature verifies under *some* ring key,
serialize it, and verify it.
"""

import hashlib
import time

from zkecdsa_tpu_torch import (
    SignatureProofList,
    generate_params_list,
    key_to_int,
    prove_signature_list,
    read_json,
    verify_signature_list,
    write_json,
)
from zkecdsa_tpu_torch import ecdsa


def main() -> None:
    plain_msg = "kilroy was here"
    msg = plain_msg.encode()
    print(f"Message: {plain_msg}")

    # Generate a keypair and sign as usual.
    keypair = ecdsa.generate_keypair()
    signature = ecdsa.sign(keypair, msg)

    # Add the public key to an existing ring of keys.
    pub_raw = ecdsa.export_public_raw(keypair)
    list_keys = [key_to_int(pub_raw), 4, 5, 6, 7, 8]

    # Create a zero-knowledge proof about the signature.
    params = generate_params_list()
    msg_hash = hashlib.sha256(msg).digest()
    t0 = time.perf_counter()
    proof = prove_signature_list(
        params, msg_hash, signature, pub_raw, 0, list_keys
    )
    t1 = time.perf_counter()
    proof_json = write_json(SignatureProofList, proof)
    print(f"Proof JSON size: {len(proof_json)} bytes.")
    print(f"Prove time (host scalar path): {t1 - t0:.2f}s")

    # Verify the round-tripped proof.
    proof2 = read_json(SignatureProofList, proof_json)
    t2 = time.perf_counter()
    valid = verify_signature_list(params, msg_hash, list_keys, proof2)
    t3 = time.perf_counter()
    print(f"Verify time (host scalar path): {t3 - t2:.2f}s")
    print(f"Valid signature: {valid}")
    assert valid


if __name__ == "__main__":
    main()
