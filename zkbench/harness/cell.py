"""One run of one cell: set-up, the measured window (or, traced, the
traced batches), the comparison with the plain reference, and the result
line.

The window is a closed loop with one caller: whole batches back to back
until a batch completes past ``seconds``.  A prove batch is
``BatchProver.prove`` on ``batch`` distinct pool instances with fresh
tapes, then each proof to its wire JSON (``serde.write_json``); a verify
batch is each proof parsed from its wire JSON (``serde.read_json``), then
``BatchVerifier.verify``.  Each ends in a synchronise of the card.

The verifier draws its round sample and its batch check's weights from the
port's default source, the OS's CSPRNG, as on any single card: nothing of
``--seed`` predicts them.  The run keeps the bytes drawn (:class:`DrawLog`)
so that the reference checks the same rounds.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import sys
import time
from pathlib import Path

from zkbench.harness import check, devtrace, manifest, spans, traffic
from zkbench.roofline import model as roofline

FORBIDDEN = ("jax", "jaxlib", "flax", "zkecdsa_tpu")


class NoDevice(RuntimeError):
    """The cell's cards are not there: no result is printed."""


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name (before the first dot) is one
    the benchmark may not load; ``zkecdsa_tpu_torch`` is not one."""
    return sorted({m.split(".", 1)[0] for m in sys.modules} & set(FORBIDDEN))


class DrawLog:
    """The port's own random source with every draw kept, for the
    reference to replay: ``random_bytes`` is the source's, then one
    append."""

    def __init__(self, source) -> None:
        self.source = source
        self.kept: list[bytes] = []

    def random_bytes(self, n: int) -> bytes:
        out = self.source.random_bytes(n)
        self.kept.append(out)
        return out

    def take(self) -> bytes:
        """The bytes drawn since the last take, in order."""
        out, self.kept = b"".join(self.kept), []
        return out


@dataclasses.dataclass
class Reading:
    """What a metric's reader reads (``zkbench/metrics/<name>.py``)."""

    path: str  # "prove" or "verify"
    mix: traffic.Mix
    cfg: traffic.Config
    proofs: int  # proofs of the window's batches
    window_s: float  # the window's seconds (untraced) or the traced batches'
    setup_s: float
    spans: spans.Spans
    batches: list  # the traced batches' ids
    trace: devtrace.DeviceTrace | None
    least_s: float | None  # the roofline's least time of the traced batches
    setup_spans: dict  # set-up span -> seconds
    gc_s: dict  # traced batch -> seconds the interpreter's collector ran


def use_port_config(cfg: traffic.Config) -> None:
    """The port's module configuration for ``cfg``, set before any
    parameters or proofs are made."""
    from zkecdsa_tpu_torch.utils import config as port_config

    port_config.set_config(port_config.Config(
        sec_level=cfg.sec_level, verify_rounds=cfg.verify_rounds,
        hardened_pedersen=cfg.hardened_pedersen, hardened_gk=cfg.hardened_gk,
    ))


@dataclasses.dataclass
class VerifyPool:
    """A verify mix's pool: the port's proofs of every instance on the
    pool tapes, as wire JSON, and the tampered copies of ``plan``."""

    inst: traffic.Instances
    valid: list  # wire JSON a pool proof
    plan: list  # (pool proof, kind) a tampered proof
    bad: list  # wire JSON a tampered proof

    @classmethod
    def make(cls, prover, inst: traffic.Instances, mix: traffic.Mix, seed: int) -> "VerifyPool":
        from zkecdsa_tpu_torch.serde import write_json
        from zkecdsa_tpu_torch.utils import rng as port_rng
        from zkecdsa_tpu_torch.zkp_attest_list import SignatureProofList

        tapes = [port_rng.DeterministicSource(traffic.pool_tape(seed, i)) for i in range(mix.pool)]
        valid = [write_json(SignatureProofList, p)
                 for p in prover.prove(inst.msg_hashes, inst.sigs, inst.pubs, inst.whichs, inst.ring, tapes)]
        plan = traffic.tampered_plan(mix, seed)
        return cls(inst, valid, plan, [traffic.tamper(valid[i], kind) for i, kind in plan])

    def wire(self, entry) -> str:
        kind, i = entry
        return self.valid[i] if kind == "valid" else self.bad[i]

    def msg_hash(self, entry) -> bytes:
        kind, i = entry
        return self.inst.msg_hashes[i if kind == "valid" else self.plan[i][0]]

    def kind(self, entry) -> str:
        return "valid" if entry[0] == "valid" else self.plan[entry[1]][1]


def port(root: Path):
    """The port, imported from the checkout at ``root`` and nowhere else."""
    import zkecdsa_tpu_torch

    where = Path(zkecdsa_tpu_torch.__file__).resolve()
    if root.resolve() not in where.parents:
        raise ImportError(f"zkecdsa_tpu_torch comes from {where}, outside the checkout {root}")
    return zkecdsa_tpu_torch


def run(workload: str, seed: int, seconds: float, trace: bool, *, t_start: float,
        device: str = "cuda", root: Path = manifest.ROOT, overrides: dict | None = None,
        man: dict | None = None, log=None) -> dict:
    """One run; returns the result line's object.  ``overrides`` replaces
    fields of the mix and the configuration (small sizes for tests on the
    CPU); ``device="cpu"`` runs the port's plain versions; ``man`` stands
    for ``BENCHMARK.json`` (a cell it does not hold yet, in tests)."""
    if log is None:
        def log(msg):
            print(msg, file=sys.stderr, flush=True)
    bench_dir = root / "zkbench"
    man = man or manifest.load(root)
    spec = manifest.cell(man, workload)
    import torch

    if device == "cuda":
        if not torch.cuda.is_available():
            raise NoDevice("CUDA is not available: this benchmark measures the card and runs nowhere else")
        if torch.cuda.device_count() < spec["chips"]:
            raise NoDevice(f"{workload} needs {spec['chips']} cards, {torch.cuda.device_count()} are visible")
    cfg = traffic.Config.load(manifest.config_file(man, spec["config"], root))
    mix = traffic.Mix.load(manifest.traffic_file(spec["traffic"], bench_dir))
    overrides = overrides or {}
    cfg = dataclasses.replace(cfg, **{k: v for k, v in overrides.items() if hasattr(cfg, k)})
    mix = dataclasses.replace(mix, **{k: v for k, v in overrides.items() if hasattr(mix, k)})
    metric_specs = manifest.metrics_for(man, workload, trace)
    readers = {m["name"]: manifest.reader(m["name"], bench_dir) for m in metric_specs}

    port(root)
    from zkecdsa_tpu_torch.protocol.batch import BatchProver
    from zkecdsa_tpu_torch.protocol.batch_verify import BatchVerifier
    from zkecdsa_tpu_torch.serde import read_json, write_json
    from zkecdsa_tpu_torch.utils import rng as port_rng
    from zkecdsa_tpu_torch.zkp_attest_list import SignatureProofList, SystemParametersList

    use_port_config(cfg)
    dev = torch.device(device)
    cuda = dev.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    sp = spans.Spans(sync=sync, record=trace)
    cfg_job = dataclasses.asdict(cfg)

    # ---- set-up: instances, parameters, device tables, warm-up ----
    inst = traffic.make_instances(cfg, mix.pool, seed)
    log(f"# {workload} seed {seed}: {mix.pool} instances over a ring of {cfg.ring} "
        f"({time.perf_counter() - t_start:.3f} s from start)")
    params = read_json(SystemParametersList, inst.params_json)
    t0 = time.perf_counter()
    with sp.stage("device_params"):
        prover = BatchProver(params, dev)
    device_params_s = time.perf_counter() - t0
    B = mix.batch

    def prove_call(b, timer=None):
        idx, tapes = traffic.prove_batch(mix, seed, b)
        proofs = prover.prove(
            [inst.msg_hashes[i] for i in idx], [inst.sigs[i] for i in idx], [inst.pubs[i] for i in idx],
            [inst.whichs[i] for i in idx], inst.ring, [port_rng.DeterministicSource(t) for t in tapes],
            timer=timer,
        )
        with (timer.stage("serde") if timer is not None else contextlib.nullcontext()):
            wires = [write_json(SignatureProofList, p) for p in proofs]
        sync()
        return idx, tapes, proofs, wires

    if mix.path == "prove":
        prover.warmup(B, e=(40,), ring=cfg.ring)
        prove_call(-1)  # a batch the window does not send: every shape once
    else:
        pool = VerifyPool.make(prover, inst, mix, seed)
        wire_of, hash_of = pool.wire, pool.msg_hash
        verifier = BatchVerifier(params, dev)
        draws = DrawLog(port_rng.get_source())
        port_rng.set_source(draws)
        batch_draws = {}

        def verify_call(b, timer=None):
            slots = traffic.verify_batch(mix, seed, b)
            with (timer.stage("serde") if timer is not None else contextlib.nullcontext()):
                proofs = [read_json(SignatureProofList, wire_of(e)) for e in slots]
            ok = verifier.verify([hash_of(e) for e in slots], inst.ring, proofs, timer=timer)
            sync()
            batch_draws[b] = draws.take()
            return slots, ok

        verify_call(-1)
    sync()
    gc.collect()  # the set-up's garbage, before the window
    collector = _GcClock() if trace else None

    # ---- the window, or the traced batches ----
    kept, w_slots, w_verdicts = [], [], []
    missing, n_proofs, b = 0, 0, 0
    traced, least, dtrace, gc_s = [], 0.0, None, {}
    prof = path = None
    if trace:
        prof, path = devtrace.capture()
        prof.__enter__()
    setup_s = time.perf_counter() - t_start
    w0 = time.perf_counter()
    while True:
        t_b = time.perf_counter()
        sp.batch = b
        timer = sp if trace else None
        with (sp.stage("batch") if trace else contextlib.nullcontext()):
            if mix.path == "prove":
                idx, tapes, proofs, wires = prove_call(b, timer)
            else:
                slots, ok = verify_call(b, timer)
        n_proofs += B
        if mix.path == "prove":
            missing += B - len(wires)
            for j in slots_to_keep(seed, b, B, mix.check):
                if j < len(wires):
                    kept.append((b, j, wires[j], idx[j], tapes[j]))
            if trace:
                traced.append(b)
                K = sum(1 for p in proofs for r in p.expProof if r.z is not None)
                least += roofline.batch_least_seconds("prove", _sizes(cfg, B, K=K))
            del proofs, wires
        else:
            missing += B - len(ok)
            for j, (e, v) in enumerate(zip(slots, ok)):
                w_slots.append((b, j, e))
                w_verdicts.append(bool(v))
            if trace:
                traced.append(b)
                least += roofline.batch_least_seconds("verify", _sizes(cfg, B, S=cfg.verify_rounds))
        if trace:
            gc_s[b] = collector.take()
        log(f"# batch {b}: {B} proofs in {time.perf_counter() - t_b:.4f} s")
        b += 1
        if (trace and b >= mix.trace_batches) or (not trace and time.perf_counter() - w0 >= seconds):
            break
    window_s = time.perf_counter() - w0
    sync()
    if trace:
        collector.close()
        log("# collector seconds a batch: " + ", ".join(f"{b}: {v:.3f}" for b, v in gc_s.items()))
        log("# spans and the span each nested in: " + ", ".join(f"{k} < {v}" for k, v in sorted(sp.parents.items())))
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    if trace:
        prof.__exit__(None, None, None)
        prof.export_chrome_trace(path)
        del prof
        dtrace = devtrace.read(path, "batch")
        Path(path).unlink()
    found = forbidden_modules()

    # ---- the program's state freed, then the reference ----
    del prover
    if mix.path == "verify":
        port_rng.set_source(draws.source)
        del verifier
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    if mix.path == "prove":
        def make_job(k):
            _, _, _, i, tape = k
            return dict(cfg=cfg_job, params_json=inst.params_json, msg_hash=inst.msg_hashes[i],
                        sig=inst.sigs[i], pub=inst.pubs[i], which=inst.whichs[i], ring=inst.ring, tape=tape)
        numbers, n_checked = check.judge_prove(seed, kept, mix.check, make_job, missing)
    else:
        cut = {}

        def make_job(i):
            b, j, e = w_slots[i]
            if b not in cut:
                cut[b] = check.slot_draws(batch_draws[b], B, cfg.sec_level, cfg.verify_rounds)
            return dict(cfg=cfg_job, params_json=inst.params_json, msg_hash=hash_of(e), ring=inst.ring,
                        wire=wire_of(e), rounds=cfg.verify_rounds, draws=cut[b][j] if j < len(cut[b]) else b"")
        numbers, n_checked = check.judge_verify(seed, w_slots, w_verdicts, pool.kind, mix.check, make_job, missing)
    correct = check.passed(numbers) and n_checked > 0
    log(f"# reference: {n_checked} answers worked out again in {time.perf_counter() - t_ref:.3f} s")

    reading = Reading(
        path=mix.path, mix=mix, cfg=cfg, proofs=n_proofs, window_s=window_s, setup_s=setup_s,
        spans=sp, batches=traced, trace=dtrace, least_s=least if trace else None,
        setup_spans={"device_params": device_params_s}, gc_s=gc_s,
    )
    metrics = {}
    for m in metric_specs:
        v = readers[m["name"]](reading)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    out = {
        "correct": correct,
        "attempted": n_proofs,
        "failed": missing,
        "metrics": metrics,
        "device": {
            "platform": "gpu" if cuda else "cpu",
            "kind": torch.cuda.get_device_name(dev) if cuda else "cpu",
            "count": 1 if cuda else 0,
            "memory_peak_bytes": peak,
        },
    }
    if trace:
        out["device"]["busy_s"] = dtrace.busy_s
        out["device"]["window_s"] = dtrace.window_s
        top = sorted(dtrace.kernels.items(), key=lambda kv: -kv[1])[:10]
        gaps = sorted(dtrace.idle.items(), key=lambda kv: -kv[1])[:10]
        out["breakdown"] = {"device_ops": [[k, v] for k, v in top], "idle_gaps": [[k, v] for k, v in gaps]}
    out["checks"] = check.checks_line(numbers)
    out["forbidden_modules"] = found
    return out


class _GcClock:
    """The seconds the interpreter's cyclic garbage collector ran between
    two reads (``gc.callbacks``)."""

    def __init__(self) -> None:
        self.s = 0.0
        self._t0 = None
        gc.callbacks.append(self._cb)

    def _cb(self, phase, info):
        if phase == "start":
            self._t0 = time.perf_counter()
        elif self._t0 is not None:
            self.s += time.perf_counter() - self._t0
            self._t0 = None

    def take(self) -> float:
        out, self.s = self.s, 0.0
        return out

    def close(self) -> None:
        gc.callbacks.remove(self._cb)


def slots_to_keep(seed: int, b: int, B: int, k: int) -> list[int]:
    """The slots of batch ``b`` whose proofs stay candidates for the
    reference sample (``k`` a batch, drawn from the seed)."""
    import random

    return sorted(random.Random(traffic.sub_seed(seed, "keep", b)).sample(range(B), min(k, B)))


def _sizes(cfg: traffic.Config, N: int, **more) -> dict:
    ring = 1 << (cfg.ring - 1).bit_length() if cfg.ring > 1 else 1
    return dict(N=N, RING=ring, n=(ring - 1).bit_length(), E=cfg.sec_level, **more)
