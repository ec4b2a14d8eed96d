"""Configuration.

The reference exposes one knob (secLevel, default 80;
reference src/zkpAttestList.ts:88) plus compile-time curve constants.
Every field here is read by the code:

* ``sec_level``   - default for :func:`zkp_attest_list.generate_params_list`.
* ``verify_rounds`` - the top-level verifier's spot-check count
  (zkpAttestList.ts:177 hardcodes 20; read by both the scalar verifier and
  ``protocol.batch_verify``).
* ``profile_dir`` - when set, ``utils.profiling.trace`` writes a
  ``torch.profiler`` Chrome trace there.
* ``pippenger_min_t`` - term-count threshold from which the batch
  verifier's per-row identity MSMs take the bucket (Pippenger) kernels
  instead of the Straus kernel (``protocol.batch_verify``); 0 disables the
  bucket path.
* ``hardened_pedersen`` / ``hardened_gk`` - opt-in hardened security
  modes, read by ``commit.pedersen`` and the GK prove/verify paths
  respectively; see the dataclass comments.

Env overrides: ``ZKECDSA_<FIELD>`` (e.g. ZKECDSA_VERIFY_ROUNDS=80 makes the
verifier check every round; ZKECDSA_PROFILE_DIR=build/trace).
"""

from __future__ import annotations

import dataclasses
import os

__all__ = ["Config", "get_config", "set_config"]


@dataclasses.dataclass
class Config:
    sec_level: int = 80  # prover rounds (zkpAttestList.ts:88)
    verify_rounds: int = 20  # top-level verifier spot-checks (":177")
    profile_dir: str | None = None  # torch.profiler trace output
    pippenger_min_t: int = 0  # MSM bucket-kernel threshold (0 = never)
    # Hardened security modes (both default OFF for wire compatibility
    # with the reference's flagged-insecure choices):
    # * hardened_pedersen - derive the Pedersen base h by deterministic
    #   try-and-increment hash-to-curve instead of h = r*g with known
    #   dlog (answers pedersen.ts:62 "todo(correctness): we must generate
    #   h without using scalar mult").
    # * hardened_gk - bind the GK one-out-of-many challenge to the
    #   statement (the commitment + the public ring values), answering
    #   gk.ts:178 "TODO: hash in the statement as well".  Proofs made
    #   with the flag verify only with the flag (both sides read it).
    hardened_pedersen: int = 0
    hardened_gk: int = 0

    @classmethod
    def from_env(cls) -> "Config":
        """Defaults overridden by ``ZKECDSA_<FIELD>`` env vars; fields with
        int defaults are parsed as int, everything else taken as string."""
        cfg = cls()
        for field in dataclasses.fields(cls):
            env = os.environ.get("ZKECDSA_" + field.name.upper())
            if env is None:
                continue
            is_int = isinstance(getattr(cfg, field.name), int)
            setattr(cfg, field.name, int(env) if is_int else env)
        return cfg


_config = Config.from_env()


def get_config() -> Config:
    return _config


def set_config(cfg: Config) -> None:
    global _config
    _config = cfg
