"""The port's counters and spans in verify batches at the benchmark's size.

    python3 tools/torch_trace_probe.py [out.json] [--batches 3] [--seed N]

On the card by default (``--device cpu --batch 2 --pool 4 --ring 16`` for
a rehearsal).  Makes the verify cell's pool as the benchmark does
(``zkbench``'s configuration ``ref-ring4096`` and mix ``verify``: 256 wire
proofs a batch over a ring of 4,096, 1 slot in 32 tampered), then runs
batches - the wire parse, then ``BatchVerifier.verify`` - each under
``profiling.tracing`` of its own ``StageTimer`` on the device, inside the
spans ``batch`` and ``serde``, with the port's default OS source wrapped to
keep its calls and bytes.  Prints, a batch: its seconds, the stages' self
seconds, every counter by span, whether ``rng.os_calls`` and
``rng.os_bytes`` equal the wrapper's tallies, the assembly's counters
inside ``verify.assemble`` (``assemble.proofs``, ``assemble.hashes``, the
weights as ``rnd.calls`` and the source calls for them as
``rng.os_calls``), and the wire's split: the
proofs the native decoder read (``serde.native``) against the Python
path's (``serde.fallback``), and the ``serde`` span's self seconds as the
native call (``serde.native_s``), ``json.loads`` (``serde.json_s``), the
collector (``gc.s``) and the rest, the object build; then one untraced batch,
what a counting site costs with no tracer installed (the executions a
batch of each site times its measured cost) and what the counting adds to
a one-byte OS draw with one installed (times the batch's OS calls).
Writes it all to ``out.json`` (default ``build/trace_probe.json``);
exits 1 if a batch's OS counters differ from the wrapper's.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


class CountingSource:
    """The port's source with its calls and bytes kept."""

    def __init__(self, source) -> None:
        self.source = source
        self.calls = self.bytes = 0

    def random_bytes(self, n: int) -> bytes:
        self.calls += 1
        self.bytes += n
        return self.source.random_bytes(n)


def by_name(counters: dict) -> dict:
    out: dict = {}
    for (_, name), n in counters.items():
        out[name] = out.get(name, 0) + n
    return out


def wire_split(t) -> dict:
    """The ``serde`` span of a traced batch: proofs by path, and its self
    seconds as the native call, ``json.loads``, the collector and the rest
    (the objects built from the native output, or the Python decode)."""
    c = {name: v for (span, name), v in t.counters.items() if span == "serde"}
    native, fallback = c.get("serde.native", 0), c.get("serde.fallback", 0)
    span = t.self_s.get("serde", 0.0)
    native_s, json_s, gc_s = c.get("serde.native_s", 0.0), c.get("serde.json_s", 0.0), c.get("gc.s", 0.0)
    return {"native": native, "fallback": fallback, "native_share": native / max(native + fallback, 1),
            "span_s": span, "native_s": native_s, "json_s": json_s, "gc_s": gc_s,
            "build_s": span - native_s - json_s - gc_s}


def site_cost_ns(reps: int = 2_000_000) -> dict:
    """ns a counting site adds with no tracer installed: the ``TRACER``
    test (every site), and ``rnd``'s attempt count (each attempt)."""
    from zkecdsa_tpu_torch.utils import profiling

    def empty(n):
        for _ in range(n):
            pass

    def test(n):
        for _ in range(n):
            if profiling.TRACER is None:
                pass

    def bump(n):
        draws = 1
        for _ in range(n):
            draws += 1

    def best(fn):
        ts = []
        for _ in range(5):
            t0 = time.perf_counter_ns()
            fn(reps)
            ts.append(time.perf_counter_ns() - t0)
        return min(ts) / reps

    floor = best(empty)
    return {"tracer_test_ns": best(test) - floor, "attempt_count_ns": best(bump) - floor}


def traced_cost_ns(reps: int = 200_000) -> dict:
    """ns a one-byte OS draw through ``bignum.rnd`` (the round sample's
    kind) takes with no tracer and with one installed, best of 5 in turns:
    their difference is what the counting adds a draw."""
    from zkecdsa_tpu_torch.bignum import big
    from zkecdsa_tpu_torch.utils import profiling
    from zkecdsa_tpu_torch.utils import rng as port_rng

    def draws(n):
        t0 = time.perf_counter_ns()
        for _ in range(n):
            big.rnd(255)  # one byte, rejected 1 time in 256
        return (time.perf_counter_ns() - t0) / n

    off, on = [], []
    with port_rng.scoped(port_rng.RandomSource()):
        for _ in range(5):
            off.append(draws(reps))
            with profiling.tracing(profiling.StageTimer()):
                on.append(draws(reps))
    return {"draw_off_ns": min(off), "draw_on_ns": min(on)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("out", nargs="?", default=str(ROOT / "build" / "trace_probe.json"))
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--batches", type=int, default=3)
    ap.add_argument("--seed", type=int, default=9_500_000_001)
    ap.add_argument("--batch", type=int)
    ap.add_argument("--pool", type=int)
    ap.add_argument("--ring", type=int)
    args = ap.parse_args(argv)

    import torch

    from zkbench.harness import cell, traffic
    from zkecdsa_tpu_torch.protocol.batch import BatchProver
    from zkecdsa_tpu_torch.protocol.batch_verify import BatchVerifier
    from zkecdsa_tpu_torch.serde import read_json
    from zkecdsa_tpu_torch.utils import profiling
    from zkecdsa_tpu_torch.utils import rng as port_rng
    from zkecdsa_tpu_torch.zkp_attest_list import SignatureProofList, SystemParametersList

    cfg = traffic.Config.load(ROOT / "zkbench" / "configs" / "ref-ring4096.json")
    mix = traffic.Mix.load(ROOT / "zkbench" / "traffic" / "verify.json")
    if args.ring:
        cfg = dataclasses.replace(cfg, ring=args.ring)
    if args.batch:
        mix = dataclasses.replace(mix, batch=args.batch, pool=args.pool or args.batch, tampered=4, tamper_every=2)
    cell.use_port_config(cfg)
    dev = torch.device(args.device)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    t0 = time.perf_counter()
    inst = traffic.make_instances(cfg, mix.pool, args.seed)
    params = read_json(SystemParametersList, inst.params_json)
    prover = BatchProver(params, dev)
    pool = cell.VerifyPool.make(prover, inst, mix, args.seed)
    verifier = BatchVerifier(params, dev)
    src = CountingSource(port_rng.get_source())
    port_rng.set_source(src)
    print(f"# set-up {time.perf_counter() - t0:.3f} s: {mix.batch} proofs a batch, ring {cfg.ring}", flush=True)

    def batch(b, timer):
        slots = traffic.verify_batch(mix, args.seed, b)
        stage = profiling.stages(timer)
        with stage("batch"):
            with stage("serde"):
                proofs = [read_json(SignatureProofList, pool.wire(e)) for e in slots]
            ok = verifier.verify([pool.msg_hash(e) for e in slots], inst.ring, proofs)
            sync()
        return ok

    batch(-1, None)
    gc.collect()
    out = {"device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu", "batch": mix.batch,
           "ring": cfg.ring, "seed": args.seed, "batches": []}
    for b in range(args.batches):
        t = profiling.StageTimer(dev)
        src.calls = src.bytes = 0
        t_b = time.perf_counter()
        with profiling.tracing(t):
            ok = batch(b, t)
        wall = time.perf_counter() - t_b
        total = by_name(t.counters)
        same = total.get("rng.os_calls") == src.calls and total.get("rng.os_bytes") == src.bytes
        asm = {name: v for (span, name), v in t.counters.items() if span == "verify.assemble"}
        rec = {
            "batch": b, "wall_s": wall, "rejected": ok.count(False), "self_s": t.self_s, "stages_s": t.stages,
            "counters": total, "counters_by_span": [[s, n, v] for (s, n), v in sorted(t.counters.items(),
                                                                                      key=lambda kv: (kv[0][0] or "", kv[0][1]))],
            "wrapper_calls": src.calls, "wrapper_bytes": src.bytes, "os_counts_equal_wrapper": same,
            "wire": wire_split(t), "assembly_weights": asm.get("rnd.calls", 0),
        }
        out["batches"].append(rec)
        w = rec["wire"]
        print(f"# batch {b}: {wall:.4f} s, {ok.count(False)} rejected; os counters equal the wrapper's: {same} "
              f"({src.calls} calls, {src.bytes} bytes)", flush=True)
        print(f"# assemble: {asm.get('assemble.proofs', 0)} proofs, {asm.get('rnd.calls', 0)} weights in "
              f"{asm.get('rng.os_calls', 0)} OS calls ({asm.get('rng.os_s', 0.0):.4f} s), "
              f"{asm.get('assemble.hashes', 0)} challenges", flush=True)
        print(f"# wire: {w['native']} of {w['native'] + w['fallback']} proofs native ({100 * w['native_share']:.1f}%); "
              f"serde {w['span_s']:.4f} s = native call {w['native_s']:.4f} + json.loads {w['json_s']:.4f} "
              f"+ collector {w['gc_s']:.4f} + object build {w['build_s']:.4f}", flush=True)
        print(t.report(), flush=True)
    t_b = time.perf_counter()
    batch(args.batches, None)
    out["untraced_wall_s"] = time.perf_counter() - t_b
    print(f"# untraced batch: {out['untraced_wall_s']:.4f} s", flush=True)
    cost = site_cost_ns()
    last = out["batches"][-1]["counters"]
    # the OS source, rnd, read_json; rnd_many tests once for all its weights
    weights = out["batches"][-1]["assembly_weights"]
    sites = last.get("rng.os_calls", 0) + last.get("rnd.calls", 0) - weights + mix.batch
    attempts = last.get("rnd.draws", 0) - weights
    off_s = (sites * cost["tracer_test_ns"] + attempts * cost["attempt_count_ns"]) * 1e-9
    out["off_cost"] = dict(cost, sites=sites, attempts=attempts, seconds=off_s,
                           share_of_untraced_batch=off_s / out["untraced_wall_s"])
    print(f"# off: {sites} site tests x {cost['tracer_test_ns']:.2f} ns + {attempts} attempts x "
          f"{cost['attempt_count_ns']:.2f} ns = {off_s * 1e3:.3f} ms, "
          f"{100 * off_s / out['untraced_wall_s']:.4f}% of the untraced batch", flush=True)
    on = traced_cost_ns()
    on_s = last.get("rng.os_calls", 0) * (on["draw_on_ns"] - on["draw_off_ns"]) * 1e-9
    out["on_cost"] = dict(on, seconds=on_s, share_of_untraced_batch=on_s / out["untraced_wall_s"])
    print(f"# on: a one-byte draw {on['draw_off_ns']:.1f} ns untraced, {on['draw_on_ns']:.1f} ns traced; "
          f"x {last.get('rng.os_calls', 0)} OS calls = {on_s * 1e3:.3f} ms, "
          f"{100 * on_s / out['untraced_wall_s']:.4f}% of the untraced batch", flush=True)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(out, indent=1))
    return 0 if all(r["os_counts_equal_wrapper"] for r in out["batches"]) else 1


if __name__ == "__main__":
    sys.exit(main())
