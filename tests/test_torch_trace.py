"""The port's spans and counters (``lac_tpu_torch.metrics``: ``Tracer``,
``span``, ``count``, ``tracing``) on the LM coding path, on the CPU with the
``prng:tiny:0`` model: nothing is recorded and no profiler annotation is
made without a tracer, the containers are the same bytes with one, spans
nest and share their API call's id, waves carry their live and padded
lanes, raw blocks and quantizations are counted, and the records reach a
JSONL file through ``Tracer.write`` and the CLI's ``--trace FILE``."""

import json

import numpy as np
import pytest
import torch

from lac_tpu_torch import cli, metrics
from lac_tpu_torch.runtime import lm_api
from lac_tpu_torch.smoke import heldout_slice
from lac_tpu_torch.stream.container import read_container

KW = dict(model_ref="prng:tiny:0", block_tokens=64, lanes=4, cache_grow=16, device="cpu")
DATA = heldout_slice()[: 3 * 64 - 10]  # 3 blocks at 4 lanes: one wave, one lane padded


@pytest.fixture
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _round_trip(data=DATA, **kw):
    c = lm_api.lm_compress_bytes(data, **dict(KW, **kw))
    assert lm_api.lm_decompress_bytes(c, device="cpu") == data
    return c


def _by_call(tracer) -> dict:
    out = {}
    for s in tracer.spans():
        out.setdefault(s["call"], []).append(s)
    return out


def test_no_tracer_makes_no_annotation_and_the_bytes_do_not_move(one_thread, monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("record_function called with no tracer installed")

    assert metrics.set_tracer(None) is None
    assert metrics.span("lac.x") is metrics.span("lac.y", n=1)  # the shared no-op
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    plain = _round_trip()
    metrics.count("graph.replays", 3)  # nothing to count into
    monkeypatch.undo()
    with metrics.tracing() as tracer:
        traced = _round_trip()
    assert traced == plain
    assert tracer.spans("lac.api.compress") and metrics.set_tracer(None) is None


def test_spans_nest_inside_their_parents_and_share_their_call(one_thread):
    with metrics.tracing() as tracer:
        _round_trip()
    spans = tracer.spans()
    by_id = {s["id"]: s for s in spans}
    for s in spans:
        assert s["t0"] <= s["t1"]
        if s["parent"] is None:
            assert s["call"] == s["id"]
            continue
        p = by_id[s["parent"]]
        assert p["t0"] <= s["t0"] and s["t1"] <= p["t1"], (s, p)
        assert s["call"] == p["call"]
    calls = _by_call(tracer)
    assert [by_id[c]["name"] for c in calls] == ["lac.api.compress", "lac.api.decompress"]
    names = {c: {s["name"] for s in ss} for c, ss in calls.items()}
    enc, dec = names.values()
    assert {"lac.api.prepare", "lac.engine.fingerprint", "lac.api.wave", "lac.api.assemble",
            "lac.engine.schedule", "lac.step.run", "lac.engine.grow", "lac.coder.encode_scan",
            "lac.api.fetch", "lac.api.pack", "lac.container.write"} <= enc
    assert {"lac.container.read", "lac.api.prepare", "lac.api.wave"} <= dec


def test_a_wave_of_three_blocks_at_four_lanes_has_one_padded_lane(one_thread):
    with metrics.tracing() as tracer:
        lm_api.lm_compress_bytes(DATA, **KW)
    (wave,) = tracer.spans("lac.api.wave")
    assert wave["meta"] == {"direction": "enc", "first": 0, "lanes": 4, "live": 3,
                            "block_tokens": 64, "symbols": len(DATA)}
    assert tracer.totals["api.lanes_live"] == 3 and tracer.totals["api.lanes_padded"] == 1
    steps = tracer.spans("lac.step.run")
    assert [s["meta"]["width"] for s in steps] == [16, 32, 48, 64]
    assert tracer.totals["step.eager"] == 64  # the CPU steps every position eagerly


def test_an_incompressible_block_counts_a_raw_block(one_thread):
    noise = bytes(np.random.default_rng(5).integers(0, 256, 150, dtype=np.uint8))
    with metrics.tracing() as tracer:
        c = _round_trip(noise)
    _, blocks = read_container(c)
    raw = sum(1 for b in blocks if b.token_count == 0)
    assert raw >= 1 and tracer.totals["api.raw_blocks"] == raw


@pytest.mark.parametrize("w8", [False, True])
def test_quantize_once_a_call_under_w8(one_thread, w8):
    with metrics.tracing() as tracer:
        _round_trip(w8=w8)
    calls = _by_call(tracer)
    assert len(calls) == 2
    for spans in calls.values():
        got = [s["meta"] for s in spans if s["name"] == "lac.model.quantize"]
        assert got == ([{"kind": "w8"}] if w8 else [])
        (top,) = [s for s in spans if s["parent"] is None]
        assert top["meta"]["w8"] is w8


def test_tracer_write_puts_one_json_line_a_record(one_thread, tmp_path):
    with metrics.tracing() as tracer:
        lm_api.lm_compress_bytes(DATA, **KW)
    path = tmp_path / "trace.jsonl"
    logger = metrics.JsonlLogger(str(path))
    try:
        tracer.write(logger)
    finally:
        logger.close()
    lines = [json.loads(x) for x in path.read_text().splitlines()]
    assert len(lines) == len(tracer.records)
    assert [x["event"] for x in lines] == [r["kind"] for r in tracer.records]
    assert {x["name"] for x in lines if x["event"] == "count"} == {
        "api.lanes_live", "api.lanes_padded", "step.eager", "api.raw_blocks"}


def test_cli_trace_writes_the_records(one_thread, tmp_path):
    src, trace = tmp_path / "data.bin", tmp_path / "trace.jsonl"
    src.write_bytes(DATA)
    args = ["--model", "lm", "--model-ref", "prng:tiny:0", "--block-tokens", "64", "--lanes",
            "4", "--cache-grow", "16", "--device", "cpu"]
    assert cli.main(["compress", str(src), *args, "--trace", str(trace)]) == 0
    assert cli.main(["decompress", f"{src}.lac", "-o", str(tmp_path / "back"), "--device",
                     "cpu", "--trace", str(trace)]) == 0
    assert (tmp_path / "back").read_bytes() == DATA
    lines = [json.loads(x) for x in trace.read_text().splitlines()]
    tops = [x["name"] for x in lines if x["event"] == "span" and x["parent"] is None]
    # decompress reads the header first, to pick the LM path
    assert tops == ["lac.api.compress", "lac.container.read", "lac.api.decompress"]
    assert metrics.set_tracer(None) is None  # the command's tracer is gone
