"""What the port counted inside its own calls in a traced run.

A traced batch hands the port's entry points the run's ``Spans`` as
``timer=``.  The port installs it for each call
(``zkecdsa_tpu_torch.utils.profiling.tracing``) and, since ``Spans`` has
no ``count``, keeps its own spans and counters for it in a ``StageTimer``,
``profiling.record_of(timer)``: the OS source's calls, bytes and seconds
(``rng.os_*``), ``bignum.rnd``'s calls and attempts (``rnd.*``), the MSM
attribution pass (the span ``msm.attribution``, ``msm.attribution_rows``,
``msm.rows_failed``) and the collector's passes (``gc.*``), each keyed by
the port's innermost open span.  Only work inside an entry point is seen:
``serde.read_json`` and the collector between the calls are not.

A port that keeps no such record gives None, and each metric read from it
is left out of the result line.
"""

from __future__ import annotations


def record(r):
    """The port's record for the run's spans, or None."""
    try:
        from zkecdsa_tpu_torch.utils import profiling
    except ImportError:
        return None
    record_of = getattr(profiling, "record_of", None)
    return record_of(r.spans) if record_of is not None else None


def counter(r, name: str) -> float | None:
    """Counter ``name`` over every span, a traced batch (0 where it never
    moved); None without a record."""
    rec = record(r)
    if rec is None or not r.batches:
        return None
    return sum(n for (_, key), n in rec.counters.items() if key == name) / len(r.batches)


def span_s(r, name: str) -> float | None:
    """Seconds of the port's spans ``name``, their children included, a
    traced batch (0 where none opened); None without a record."""
    rec = record(r)
    if rec is None or not r.batches:
        return None
    return sum(s.seconds for s in rec.spans if s.name == name) / len(r.batches)
