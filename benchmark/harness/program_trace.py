"""The program's own spans and counters (``lac_tpu_torch.metrics``'s
``Tracer``), as the per-layer readers of a traced run select them.

Importing this module installs a ``Tracer`` in the program for the rest of
the process. Only per-layer readers import it, and the runner imports them
only in a traced run (``runner._declare_spans``, before the warm-up), so a
traced run records the program's spans from its warm-up on, and the
untraced runs, which give the end-to-end numbers, run with no tracer. The
program's spans and the harness's (``harness/spans.py``) are on one clock,
``time.perf_counter``, so a reader takes the program's spans that lie
inside the window's ``call.encode`` regions. On a program whose
``metrics`` has no ``Tracer`` (before the program recorded spans), nothing
is installed, and every helper returns None.
"""

from __future__ import annotations

from lac_tpu_torch import metrics as _metrics

TRACER = None
if hasattr(_metrics, "Tracer") and hasattr(_metrics, "set_tracer"):
    TRACER = _metrics.Tracer()
    _metrics.set_tracer(TRACER)


def encode_calls(run, phase: str = "window") -> list | None:
    """The harness's ``call.encode`` spans of ``phase``, or None without a
    tracer."""
    if TRACER is None:
        return None
    return run.spans.of("call.encode", phase)


def spans(run, name: str, phase: str = "window") -> list | None:
    """The program's spans ``name`` (record dicts: ``t0``, ``t1``, ``meta``,
    ...) that lie inside an encode call of ``phase``; None without a
    tracer."""
    calls = encode_calls(run, phase)
    if calls is None:
        return None
    return [r for r in TRACER.records
            if r["kind"] == "span" and r["name"] == name
            and any(c.t0 <= r["t0"] and r["t1"] <= c.t1 for c in calls)]


def share_of_encode_calls(run, name: str) -> float | None:
    """The seconds of the program's spans ``name`` inside the window's
    encode calls over those calls' seconds, in %."""
    calls, got = encode_calls(run), spans(run, name)
    total = sum(c.seconds for c in calls or ())
    if got is None or not total:
        return None
    return 100.0 * sum(r["t1"] - r["t0"] for r in got) / total
