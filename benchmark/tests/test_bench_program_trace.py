"""CPU tests of the readers of the program's own spans
(``harness/program_trace.py`` and the per-layer metrics that read it):
known values on hand-made records, None when the program has no tracer,
and a traced run of the tiny cell that reports them."""

from __future__ import annotations

import json
import time
import types

import pytest
from conftest import BENCH

from harness import manifest, program_trace, runner, trace
from harness.spans import Span, Spans

READERS = ("captures_per_call", "capture_share", "capture_idle_share", "call_prep_share",
           "padded_lane_share")


def _reader(name):
    return manifest.load_module(BENCH / "layer_metrics" / f"{name}.py").read


def _span(name, t0, t1, **meta):
    return {"kind": "span", "name": name, "t0": t0, "t1": t1, "meta": meta}


def _run() -> runner.Record:
    """Two encode calls of 1 s (0-1 s, 2-3 s) and a decode call between
    them; the profiled call's trace: kernels at 0-100, 400-500 and 900-1000
    us, a capture annotation at 150-350 us."""
    sp = Spans()
    sp.records += [Span("call.encode", "window", 0.0, 1.0, {}),
                   Span("call.decode", "window", 1.0, 2.0, {}),
                   Span("call.encode", "window", 2.0, 3.0, {})]
    events = [{"name": "span:call.encode", "cat": "user_annotation", "ts": 0, "dur": 1000},
              {"name": "span:lac.graph.capture", "cat": "user_annotation", "ts": 150,
               "dur": 200}]
    events += [{"name": "k", "cat": "kernel", "ts": t, "dur": 100} for t in (0, 400, 900)]
    cell = types.SimpleNamespace(model={}, coding={})
    return runner.Record(cell, 1.0, 3.0, [], sp, trace.view(events))


TRACER = types.SimpleNamespace(records=[
    _span("lac.api.prepare", 0.0, 0.05),
    _span("lac.graph.capture", 0.1, 0.2, graph="step", width=128),
    _span("lac.graph.capture", 0.3, 0.35, graph="scan", chunk=64),
    _span("lac.api.wave", 0.4, 0.9, direction="enc", lanes=64, live=4, block_tokens=512,
          symbols=2048),
    {"kind": "count", "name": "graph.replays", "t": 0.5, "n": 515},
    _span("lac.api.prepare", 1.1, 1.2),  # in the decode call: not read
    _span("lac.graph.capture", 1.3, 1.4, graph="step", width=128),
    _span("lac.api.wave", 1.5, 1.9, direction="dec", lanes=64, live=4, block_tokens=512,
          symbols=2048),
    _span("lac.api.prepare", 2.0, 2.1),
    _span("lac.graph.capture", 2.1, 2.15, graph="step", width=128),
    _span("lac.api.wave", 2.2, 2.9, direction="enc", lanes=64, live=64, block_tokens=512,
          symbols=64 * 512),
])


@pytest.mark.parametrize("name,value", [
    ("captures_per_call", 3 / 2),
    ("capture_share", 100 * (0.1 + 0.05 + 0.05) / 2),
    ("capture_idle_share", 100 * 200 / (300 + 400)),
    ("call_prep_share", 100 * (0.05 + 0.1) / 2),
    ("padded_lane_share", 100 * (1 - (2048 + 64 * 512) / (2 * 64 * 512))),
])
def test_reader_on_known_spans(monkeypatch, name, value):
    monkeypatch.setattr(program_trace, "TRACER", TRACER)
    assert _reader(name)(_run()) == pytest.approx(value)


@pytest.mark.parametrize("name", READERS)
def test_reader_gives_none_without_a_program_tracer(monkeypatch, name):
    monkeypatch.setattr(program_trace, "TRACER", None)
    assert _reader(name)(_run()) is None


def test_padded_lane_share_is_zero_where_every_wave_is_full(monkeypatch):
    full = types.SimpleNamespace(records=[r for r in TRACER.records if r.get("t0", 0) >= 2.0])
    monkeypatch.setattr(program_trace, "TRACER", full)
    assert _reader("padded_lane_share")(_run()) == 0.0


def test_a_traced_tiny_run_reports_the_program_metrics(tiny):
    """The tiny cell on the CPU, with the metrics that need no trace of
    the card listed for it: four files of 64 x 4 symbols fill each wave, no
    graph is captured on the CPU, and preparation is a share of a call."""
    m = tiny.manifest()
    for x in m["per_layer"]:
        if x["name"] in READERS:
            x["workloads"].append("tiny.files")
    (tiny.root / "BENCHMARK.json").write_text(json.dumps(m))
    cell = manifest.load_cell("tiny.files", tiny.bench)
    r = runner.run(cell, 2**31 + 9, 0.5, True, "cpu", time.perf_counter())
    assert r["correct"], r["checks"]
    got = {k: v["value"] for k, v in r["metrics"].items()}
    assert got["captures_per_call"] == 0.0 and got["capture_share"] == 0.0
    assert got["padded_lane_share"] == 0.0
    assert 0 < got["call_prep_share"] < 100
    assert "capture_idle_share" not in got  # no trace on the CPU
