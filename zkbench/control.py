"""The controls of the correctness check: the plain reference put in the
program's place with one of the configuration's guarantees broken, which
the check must find not correct.

* prove cells: the reference prover at ``sec_level`` one below the
  configuration's (79 exponent rounds a proof instead of 80), the step a
  later change would be tempted by;
* verify cells: the reference verifier checking fewer exponent rounds
  than ``verify_rounds`` (20) of the sample its draws name: ``--rounds``,
  0 by default (every round and point-addition fault passes).  With its
  own draws from the OS, as the program's; the check replays them.

For each seed it makes the run's inputs (a verify cell's pool by the
port's prover, on the card), the slots a window of ``--batches`` batches
would compare, answers them by the control, judges those answers as a run
judges the program's, and prints one JSON line: the compared numbers and
``correct``, one entry a round count.  The benchmark's own runs never run
it.

    python3 zkbench/control.py --workload <name> --seeds <n>,<n>,<n> --batches <b> [--rounds 0,10,19]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def control(workload: str, seed: int, batches: int, *, rounds: tuple = (0,), device: str = "cuda",
            root: Path = ROOT, overrides: dict | None = None, man: dict | None = None) -> dict:
    import dataclasses

    from zkbench.harness import cell, check, manifest, traffic

    man = man or manifest.load(root)
    spec = manifest.cell(man, workload)
    cfg = traffic.Config.load(manifest.config_file(man, spec["config"], root))
    mix = traffic.Mix.load(manifest.traffic_file(spec["traffic"], root / "zkbench"))
    overrides = overrides or {}
    cfg = dataclasses.replace(cfg, **{k: v for k, v in overrides.items() if hasattr(cfg, k)})
    mix = dataclasses.replace(mix, **{k: v for k, v in overrides.items() if hasattr(mix, k)})
    cfg_job = dataclasses.asdict(cfg)
    inst = traffic.make_instances(cfg, mix.pool, seed)

    if mix.path == "prove":
        kept = []
        for b in range(batches):
            idx, tapes = traffic.prove_batch(mix, seed, b)
            kept += [(b, j, None, idx[j], tapes[j]) for j in cell.slots_to_keep(seed, b, mix.batch, mix.check)]

        def make_job(k, sec_level=None):
            _, _, _, i, tape = k
            return dict(cfg=cfg_job, params_json=inst.params_json, msg_hash=inst.msg_hashes[i], sig=inst.sigs[i],
                        pub=inst.pubs[i], which=inst.whichs[i], ring=inst.ring, tape=tape, sec_level=sec_level)

        sample = check.draw(seed, "prove sample", list(range(len(kept))), mix.check)
        wires = check.run_jobs(check.reference_prove, [make_job(kept[i], cfg.sec_level - 1) for i in sample])
        for i, w in zip(sample, wires):
            kept[i] = kept[i][:2] + (w,) + kept[i][3:]
        numbers, n = check.judge_prove(seed, kept, mix.check, make_job, 0)
    else:
        import torch

        cell.port(root)
        from zkecdsa_tpu_torch.protocol.batch import BatchProver
        from zkecdsa_tpu_torch.serde import read_json
        from zkecdsa_tpu_torch.zkp_attest_list import SystemParametersList

        if device == "cuda" and not torch.cuda.is_available():
            raise cell.NoDevice("CUDA is not available")
        cell.use_port_config(cfg)
        prover = BatchProver(read_json(SystemParametersList, inst.params_json), torch.device(device))
        pool = cell.VerifyPool.make(prover, inst, mix, seed)
        slots = [(b, j, e) for b in range(batches) for j, e in enumerate(traffic.verify_batch(mix, seed, b))]
        compared = check.verify_compared(seed, slots, pool.kind, mix.check)
        # the control's own draws, from the OS: a shuffle of 80 rounds takes ~900 bytes
        draws = {i: os.urandom(8192) for i in compared}

        def make_job(i, rounds=cfg.verify_rounds):
            _, _, e = slots[i]
            return dict(cfg=cfg_job, params_json=inst.params_json, ring=inst.ring, rounds=rounds,
                        msg_hash=pool.msg_hash(e), wire=pool.wire(e), draws=draws[i])

        ref = check.reference_verdicts(seed, slots, pool.kind, mix.check, make_job)
        out = {}
        for checked in rounds:
            verdicts = [None] * len(slots)
            answers = check.run_jobs(check.reference_verify, [make_job(i, checked) for i in compared])
            for i, a in zip(compared, answers):
                verdicts[i] = a
            numbers, n = check.judge_verify(seed, slots, verdicts, pool.kind, mix.check, make_job, 0, ref=ref)
            out[f"rounds_{checked}"] = {"correct": check.passed(numbers) and n > 0, "checks": check.checks_line(numbers)}
        first = out[f"rounds_{rounds[0]}"]
        return {"workload": workload, "seed": seed, "sampled": n, "correct": first["correct"],
                "checks": first["checks"], "controls": out}
    return {"workload": workload, "seed": seed, "sampled": n, "correct": check.passed(numbers) and n > 0,
            "checks": check.checks_line(numbers)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="the correctness check's controls")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--batches", type=int, required=True, help="batches a window of the cell runs")
    ap.add_argument("--rounds", default="0", help="verify cells: comma-separated rounds the control checks")
    args = ap.parse_args(argv)
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        out = control(args.workload, seed, args.batches, rounds=tuple(int(r) for r in args.rounds.split(",")))
        out["seconds"] = time.perf_counter() - t0
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
