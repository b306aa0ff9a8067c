"""What the per-layer readers share: the spans they declare on the
program's functions, and the coding steps found in them.

A ``steps`` span is one call of the step runner (``step_graph._Runner.steps``):
``n`` steps of one direction (``SegIntervals`` encodes, ``SegDecode``
decodes) at one cache width, from position ``t``. Its lanes' lengths come
from the enclosing ``lm_encode_windowed`` / ``lm_decode_windowed`` span.
"""

from __future__ import annotations

from . import counts


def _lengths(args, kwargs) -> dict:
    return {"lengths": [int(x) for x in args[3].tolist()]}


def _steps(args, kwargs) -> dict:
    runner, cache = args[0], args[1]
    n = args[2] if len(args) > 2 else kwargs["n"]
    return {"runner": type(runner).__name__, "n": int(n), "width": int(cache["k"].shape[2]),
            "t": int(runner.t.item())}


ENCODE = {"target": "lac_tpu_torch.runtime.lm_api:lm_encode_windowed", "meta": _lengths}
DECODE = {"target": "lac_tpu_torch.runtime.lm_api:lm_decode_windowed", "meta": _lengths}
STEPS = {"target": "lac_tpu_torch.runtime.step_graph:_Runner.steps", "meta": _steps}
ENCODE_SCAN = {"target": "lac_tpu_torch.runtime.lm_engine:_encode_scan"}
RUNNER = {"enc": ("SegIntervals", "lm_encode_windowed"), "dec": ("SegDecode", "lm_decode_windowed")}


def steps(run, direction: str, phase: str = "window") -> list:
    """[(steps span, the lanes' lengths)] of one direction."""
    runner, outer = RUNNER[direction]
    calls = run.spans.of(outer, phase)
    out = []
    for s in run.spans.of("steps", phase):
        if s.meta["runner"] != runner or s.meta["n"] <= 0:
            continue
        host = [c for c in calls if c.t0 <= s.t0 and s.t1 <= c.t1]
        out.append((s, host[-1].meta["lengths"]))
    return out


def positions(span, lengths):
    """(t, live lanes) of each step of a ``steps`` span."""
    t0 = span.meta["t"]
    return [(t, counts.live_lanes(lengths, t)) for t in range(t0, t0 + span.meta["n"])]


def sum_over_steps(run, direction: str, fn, phase: str = "window") -> float:
    """The sum of ``fn(model, coding, t, live)`` over every step of one direction."""
    m, coding = run.cell.model, run.cell.coding
    return sum(fn(m, coding, t, live)
               for s, lengths in steps(run, direction, phase)
               for t, live in positions(s, lengths))


def profiled_steps(run) -> list:
    """[(trace interval, steps span, lengths)] of the profiled encode call:
    the trace's ``span:steps`` annotations in order, beside the host's."""
    marks = sorted(run.view.spans_named("steps"), key=lambda s: s.t0)
    host = run.spans.of("steps", "profile")
    if len(marks) != len(host):
        raise RuntimeError(f"{len(marks)} steps annotations in the trace, {len(host)} spans")
    by_host = {id(s): lengths for s, lengths in steps(run, "enc", "profile")}
    return [(mk, s, by_host[id(s)]) for mk, s in zip(marks, host) if id(s) in by_host]
