"""CPU tests of the benchmark's harness: the manifest and its lookups by
name, a cell and a metric added as files, the traffic generators, the
work counts and the readers of the trace, the trace's check, the plain
references against the program's forward, the import rule, and the
faults that have to make ``correct`` false."""

from __future__ import annotations

import ast
import json
import re
import subprocess
import sys
import time

import numpy as np
import pytest
import torch
from conftest import BENCH, ROOT

from harness import check, counts, layers, manifest, runner, trace
from harness.spans import Span, Spans

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _manifest() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


# ---------------------------------------------------------------- manifest


def test_manifest_keys_and_names():
    m = _manifest()
    assert set(m) == {"command", "paths", "run_seconds", "configs", "workloads",
                      "end_to_end", "per_layer"}
    assert m["paths"] == ["benchmark"] and m["command"] == ["python3", "benchmark/run.py"]
    assert 1 <= m["run_seconds"] <= 51
    names = [c["name"] for c in m["configs"]] + [w["name"] for w in m["workloads"]]
    names += [x["name"] for x in m["end_to_end"] + m["per_layer"]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for c in m["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmark/") and (ROOT / c["file"]).is_file()
    for w in m["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200 and NAME.match(w["traffic"])
    e2e = {x["name"] for x in m["end_to_end"]}
    assert "setup_s" in e2e
    for x in m["end_to_end"]:
        assert x["source"] in ("host_clock", "device_trace") and UNIT.match(x["unit"])
        assert 0.01 <= x["bound"] <= 0.25
    for x in m["per_layer"]:
        assert x["moves"] in e2e and UNIT.match(x["unit"]) and "\n" not in x["layer"]
        assert x["better"] in ("lower", "higher")
    assert len(json.dumps(m)) < 64 * 1024


@pytest.mark.parametrize("cell", [w["name"] for w in _manifest()["workloads"]])
def test_every_cell_resolves(cell):
    c = manifest.load_cell(cell, BENCH)
    assert manifest.generator(c).make
    assert manifest.family(c).logits
    assert c.end_to_end and c.per_layer
    for m in c.end_to_end:
        assert manifest.reader(c, "end_to_end", m["name"]).read
    for m in c.per_layer:
        assert manifest.reader(c, "layer_metrics", m["name"]).read
    assert {"sample_calls", "reference_rows", "limits", "control"} <= set(c.settings)
    manifest.pinned(c.root, c.config["weights"]["path"], c.config["weights"]["sha256"]) \
        if c.config["weights"]["kind"] == "npz" else None


def test_run_py_names_no_cell_config_or_metric():
    m = _manifest()
    names = [c["name"] for c in m["configs"]] + [w["name"] for w in m["workloads"]]
    names += [x["name"] for x in m["end_to_end"] + m["per_layer"]]
    names += [w["traffic"] for w in m["workloads"]]
    for path in [BENCH / "run.py", *sorted((BENCH / "harness").glob("*.py"))]:
        text = path.read_text()
        assert not [n for n in names if re.search(rf"['\"]{re.escape(n)}['\"]", text)], path


def test_pinned_refuses_an_altered_file(tmp_path):
    f = tmp_path / "x.bin"
    f.write_bytes(b"abc")
    manifest.pinned(tmp_path, "x.bin", manifest.sha256(f))
    with pytest.raises(ValueError, match="sha256"):
        manifest.pinned(tmp_path, "x.bin", "0" * 64)
    with pytest.raises(FileNotFoundError):
        manifest.pinned(tmp_path, "y.bin", "0" * 64)


# ------------------------------------------------- a cell and a metric as files


COUNT_METRIC = '''"""Encode calls the window made (a throwaway metric of the tests)."""

SPANS = {}


def read(run):
    return float(len(run.spans.of("call.encode")))
'''


def test_throwaway_cell_and_metric_run(tiny):
    tiny.add_metric("per_layer", {"name": "encode_calls", "unit": "calls", "better": "higher",
                                  "source": "program_span", "layer": "file API",
                                  "moves": "encode_symbols_per_s",
                                  "workloads": ["tiny.files"]}, COUNT_METRIC)
    cell = manifest.load_cell("tiny.files", tiny.bench)
    r = runner.run(cell, 2**31 + 5, 0.5, True, "cpu", time.perf_counter())
    assert r["correct"], r["checks"]
    assert r["metrics"]["encode_calls"]["value"] == r["attempted"] >= 1
    assert r["metrics"]["step_ms.enc"]["value"] > 0 and r["metrics"]["step_ms.dec"]["value"] > 0
    assert 0 < r["metrics"]["api_host_share"]["value"] < 100
    assert 0 < r["metrics"]["rans_share"]["value"] < 100
    assert r["metrics"]["step_mfu"]["unit"] == "%"
    for device_metric in ("launches_per_step", "step_roofline", "device_idle"):
        assert device_metric not in r["metrics"]  # no trace on the CPU: nothing to read
    r = runner.run(cell, 3, 0.5, False, "cpu", time.perf_counter())
    assert set(r["metrics"]) == {"encode_symbols_per_s", "decode_symbols_per_s", "setup_s"}
    assert r["correct"] and r["failed"] == 0


# -------------------------------------------------------------- generators


def _ctx(cell, seed, **kw):
    import types

    return types.SimpleNamespace(seed=seed, device=torch.device("cpu"), cell=cell, **kw)


@pytest.mark.parametrize("traffic,size,stride", [("files32k", 32768, 32768),
                                                 ("files2k", 2048, 34816)])
def test_text_files_at_seeded_offsets(traffic, size, stride):
    cell = manifest.load_cell(f"byte16l.{traffic}", BENCH)
    gen = manifest.generator(cell)
    data = (BENCH / "data" / "heldout_slice.bin").read_bytes()
    a = gen.make(cell.traffic, _ctx(cell, 2**33 + 1))
    b = gen.make(cell.traffic, _ctx(cell, 2**33 + 1))
    c = gen.make(cell.traffic, _ctx(cell, 11))
    assert [a.item(i) for i in range(-1, 20)] == [b.item(i) for i in range(-1, 20)]
    assert all(len(a.item(i)) == size for i in range(-1, 20))
    assert a.key(0) != c.key(0)
    for i in range(20):  # each file is the data at its offset, taken round the end
        assert a.key(i + 1) == (a.key(i) + stride) % len(data)
        assert (data + data)[a.key(i) : a.key(i) + size] == a.item(i)
    bases = {gen.make(cell.traffic, _ctx(cell, s)).key(0) // 32768 for s in range(64)}
    assert len(bases) == 8  # the seeds' offsets cover the whole slice
    keys = {a.key(i) for i in range(len(data) // 2048)}
    assert len(keys) == (8 if stride == size else 128)


# ---------------------------------------------------------- counts and traces


M = {"vocab": 256, "d_model": 64, "n_layers": 2, "n_heads": 4, "n_kv_heads": 2, "d_ff": 128,
     "max_seq": 128, "pos_embedding": "rope", "norm": "rmsnorm", "act": "silu_glu",
     "use_bias": False, "tie_embeddings": False, "rope_theta": 10000.0, "norm_eps": 1e-5,
     "dtype": "bfloat16"}


def test_random_weights_from_the_seed(checkout):
    import types

    import reference.rope_glu as fam
    from harness import weights as wm

    m = dict(M, dtype="float32")
    cell = types.SimpleNamespace(model=m, config={"family": "rope_glu", "weights": {
        "kind": "random", "std": 0.02, "fill": {"final_norm.scale": 3.0}}})
    a, b, c = (wm.make(cell, fam, s, torch.device("cpu")) for s in (2**32 + 9, 2**32 + 9, 5))
    assert set(a) == set(fam.param_shapes(m))
    assert all(torch.equal(a[k], b[k]) for k in a) and not torch.equal(a["embed"], c["embed"])
    assert float(a["final_norm.scale"].min()) == float(a["final_norm.scale"].max()) == 3.0
    assert float(a["layers.0.ln1.scale"].min()) == 1.0
    assert a["layers.1.wo"].std() < a["layers.1.wq"].std() / 1.5  # residual outputs scaled


def test_counts_by_hand():
    # a layer: wq 64x64, wk 64x32, wv 64x32, wo 64x64, w_up, w_gate 64x128, w_down 128x64
    layer = 4096 + 2048 + 2048 + 4096 + 3 * 8192
    assert counts.matmul_params(M) == 2 * layer + 64 * 256
    assert counts.step_flops(M, 9, 3) == 3 * (2 * (2 * layer + 64 * 256) + 4 * 64 * 10 * 2)
    weights = 2 * (2 * layer + 64 * 256) + 5 * 64 * 2
    assert counts.weight_bytes(M, {}) == weights
    assert counts.kv_row_bytes(M, {}) == 2 * 2 * (2 * 16 * 2)
    assert counts.kv_row_bytes(M, {"kv8": True}) == 2 * 2 * (2 * 16 + 4 * 2)
    assert counts.weight_bytes(M, {"w8": True}) == (2 * layer + 64 * 256) + 4 * (
        2 * (64 + 32 + 32 + 64 + 128 + 128 + 64) + 256) + 5 * 64 * 2
    assert counts.step_bytes(M, {}, 9, 3) == weights + 3 * 64 * 2 + 3 * 9 * 256
    t = counts.step_bytes(M, {}, 9, 3) / counts.PEAK_HBM_BYTES
    assert counts.step_bound_s(M, {}, 9, 3) == max(t, counts.step_flops(M, 9, 3) / 989e12)
    assert counts.live_lanes([512, 100, 0], 99) == 2


def _hand_run(kernels_per_step=3, busy_frac=0.5):
    """A traced run by hand: one encode call of 2 steps of 2 lanes (lengths
    2 and 1) at positions 0 and 1, its kernels filling ``busy_frac`` of each
    step's span."""
    import types

    sp = Spans()
    sp.records = [
        Span("call.encode", "window", 0.0, 1.0, {}),
        Span("lm_encode_windowed", "window", 0.1, 0.9, {"lengths": [2, 1]}),
        Span("encode_scan", "window", 0.7, 0.8, {}),
        Span("steps", "window", 0.2, 0.6, {"runner": "SegIntervals", "n": 2, "width": 128,
                                           "t": 0}),
        Span("call.encode", "profile", 10.0, 11.0, {}),
        Span("lm_encode_windowed", "profile", 10.1, 10.9, {"lengths": [2, 1]}),
        Span("steps", "profile", 10.2, 10.6, {"runner": "SegIntervals", "n": 2, "width": 128,
                                              "t": 0}),
    ]
    events = [{"name": trace.WARM_UP, "cat": "user_annotation", "ts": 0, "dur": 5},
              {"name": "span:call.encode", "cat": "user_annotation", "ts": 100, "dur": 1000},
              {"name": "span:steps", "cat": "user_annotation", "ts": 200, "dur": 400}]
    width = 400 * busy_frac / (2 * kernels_per_step)
    for k in range(2 * kernels_per_step):
        events.append({"name": f"k{k % kernels_per_step}", "cat": "kernel",
                       "ts": 200 + k * 400 / (2 * kernels_per_step), "dur": width,
                       "args": {"correlation": k}})
        events.append({"name": "cudaLaunchKernel", "cat": "cuda_runtime", "ts": 150 + k,
                       "dur": 1, "args": {"correlation": k}})
    cell = types.SimpleNamespace(model=M, coding={})
    return runner.Record(cell, 1.0, 1.0, [], sp, trace.view(trace.checked_events(events)))


def test_readers_on_a_hand_made_trace():
    run = _hand_run()
    rd = {n: manifest.load_module(BENCH / "layer_metrics" / f"{n}.py").read
          for n in ("launches_per_step", "step_roofline", "step_mfu", "device_idle",
                    "api_host_share", "rans_share", "step_ms.enc")}
    assert rd["launches_per_step"](run) == pytest.approx(3.0)
    bound = counts.step_bound_s(M, {}, 0, 2) + counts.step_bound_s(M, {}, 1, 1)
    assert rd["step_roofline"](run) == pytest.approx(100 * bound / 200e-6)
    flops = counts.step_flops(M, 0, 2) + counts.step_flops(M, 1, 1)
    assert rd["step_mfu"](run) == pytest.approx(100 * flops / (0.4 * counts.PEAK_BF16_FLOPS))
    assert rd["device_idle"](run) == pytest.approx(100 * (1 - 200e-6 / 1000e-6))
    assert rd["api_host_share"](run) == pytest.approx(100 * (1 - 0.8))
    assert rd["rans_share"](run) == pytest.approx(100 * 0.1 / 0.8)
    assert rd["step_ms.enc"](run) == pytest.approx(1e3 * 0.4 / 2)
    b = runner.breakdown(run.view, run.view.spans_named("call.encode")[0])
    assert [n for n, _ in b["device_ops"]] == ["k0", "k1", "k2"]
    assert b["idle_gaps"][0][0] == "call.encode" and len(b["idle_gaps"]) <= 10


def test_trace_check_refuses_a_lost_kernel():
    events = [{"name": trace.WARM_UP, "cat": "user_annotation", "ts": 0, "dur": 5},
              {"name": "cudaLaunchKernel", "cat": "cuda_runtime", "ts": 10, "dur": 1,
               "args": {"correlation": 1}},
              {"name": "cudaLaunchKernel", "cat": "cuda_runtime", "ts": 12, "dur": 1,
               "args": {"correlation": 2}},
              {"name": "k", "cat": "kernel", "ts": 11, "dur": 1, "args": {"correlation": 1}}]
    with pytest.raises(RuntimeError, match="1 of 2 kernel launches"):
        trace.checked_events(events)
    assert len(trace.checked_events(events[:2] + events[3:])) == 2


def test_trace_check_leaves_out_launches_inside_a_graph_capture():
    events = [{"name": trace.WARM_UP, "cat": "user_annotation", "ts": 0, "dur": 5},
              {"name": "cudaStreamBeginCapture", "cat": "cuda_runtime", "ts": 10, "dur": 1},
              {"name": "cudaLaunchKernel", "cat": "cuda_runtime", "ts": 12, "dur": 1,
               "args": {"correlation": 7}},
              {"name": "cudaStreamEndCapture", "cat": "cuda_runtime", "ts": 14, "dur": 1},
              {"name": "cudaLaunchKernel", "cat": "cuda_runtime", "ts": 20, "dur": 1,
               "args": {"correlation": 8}}]
    assert trace.captures(events) == [(10, 14)]
    with pytest.raises(RuntimeError, match="1 of 1 kernel launches"):
        trace.checked_events(events)  # the launch after the capture lost its kernel
    events.append({"name": "k", "cat": "kernel", "ts": 21, "dur": 1, "args": {"correlation": 8}})
    assert len(trace.checked_events(events)) == 5


def test_bits_per_byte_counts_each_file_once():
    import types

    rd = manifest.load_module(BENCH / "end_to_end" / "bits_per_byte.py").read
    calls = [{"file": 0, "container_bytes": 10, "bytes": 100},
             {"file": 1, "container_bytes": 30, "bytes": 100},
             {"file": 0, "container_bytes": 10, "bytes": 100}, {"file": 2}]
    assert rd(types.SimpleNamespace(calls=calls)) == pytest.approx(8 * 40 / 200)
    assert rd(types.SimpleNamespace(calls=[])) is None


def test_busy_and_gaps_merge_overlaps():
    v = trace.view([{"name": "a", "cat": "kernel", "ts": 0, "dur": 10},
                    {"name": "b", "cat": "gpu_memcpy", "ts": 5, "dur": 10},
                    {"name": "c", "cat": "kernel", "ts": 30, "dur": 10}])
    assert v.busy(0, 40e-6) == pytest.approx(25e-6)
    assert [round(g * 1e6) for _, g in v.gaps(0, 50e-6)] == [15, 10]
    assert len(v.kernels) == 2


# ------------------------------------------------------------- the references


@pytest.mark.parametrize("preset", ["tiny"])
def test_reference_matches_the_program_forward(preset):
    from lac_tpu_torch.models.lm_registry import PRESETS
    from lac_tpu_torch.models.transformer import forward, init_params

    import reference.rope_glu as fam

    cfg = PRESETS[preset]()
    params = init_params(cfg, 3)
    weights = {k: v.detach() for k, v in params.named_parameters()}
    m = {k: getattr(cfg, k) for k in ("vocab", "d_model", "n_layers", "n_heads", "n_kv_heads",
                                      "d_ff", "max_seq", "norm_eps", "rope_theta")}
    assert set(weights) == set(fam.param_shapes(m))
    tokens = torch.randint(0, cfg.vocab, (2, 40), generator=torch.Generator().manual_seed(1))
    tokens[:, 0] = cfg.bos_id
    with torch.inference_mode():
        want = forward(cfg, params, tokens, prefill=True)
        got = fam.logits(fam.prepare(weights, m), m, tokens)
    assert (got - want).abs().max() < 1e-4


def test_reference_quantizer_matches_the_coder_rule():
    from lac_tpu_torch.ops.quantize import quantize_logits

    from reference.common import quantize_freq

    logits = torch.randn(5, 7, 300, generator=torch.Generator().manual_seed(2)) * 3
    sym = torch.randint(0, 300, (5, 7), generator=torch.Generator().manual_seed(3))
    sym[0, 0] = logits[0, 0].argmax()
    want = torch.gather(quantize_logits(logits, 16).long(), -1, sym[..., None])[..., 0]
    assert torch.equal(quantize_freq(logits, sym, 16), want)


# --------------------------------------------------------------- import rule


def test_reference_imports_nothing_of_the_program():
    for path in sorted((BENCH / "reference").glob("*.py")):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, (ast.Import, ast.ImportFrom)):
                names = [a.name for a in node.names] if isinstance(node, ast.Import) else [
                    node.module or ""]
                assert not [n for n in names if n.split(".")[0] in
                            ("lac_tpu_torch", "lac_tpu", "jax", "harness")], (path, names)


def test_a_run_loads_no_jax(tiny):
    code = ("import sys, time; sys.path[:0] = [{b!r}, {r!r}];"
            "from harness import manifest, runner;"
            "c = manifest.load_cell('tiny.files', __import__('pathlib').Path({tb!r}));"
            "r = runner.run(c, 1, 0.2, False, 'cpu', time.perf_counter());"
            "assert r['correct'];"
            "print(runner.forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code.format(b=str(BENCH), r=str(ROOT),
                                                           tb=str(tiny.bench))],
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
    sys.modules["lac_tpu_x"] = sys.modules.get("lac_tpu_x", type(sys)("lac_tpu_x"))
    assert "lac_tpu_x" not in runner.forbidden_modules()  # whole names: not a prefix


def test_run_py_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "byte16l.files32k",
                          "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""


# -------------------------------------------------------------------- faults


def _zero_cache_rows(monkeypatch):
    """The step leaves the model's state unchanged: no K/V reaches the cache."""
    from lac_tpu_torch.models import transformer

    real = transformer._cache_rows
    monkeypatch.setattr(transformer, "_cache_rows",
                        lambda cfg, k, v: {n: t.zero_() for n, t in real(cfg, k, v).items()})


def _half_the_lanes(monkeypatch):
    """Half of each wave's lanes left out of the encode."""
    from lac_tpu_torch.runtime import lm_api

    real = lm_api.lm_encode_windowed

    def half(cfg, params, tokens, lengths, *a, **k):
        lengths = lengths.clone()
        lengths[lengths.shape[0] // 2 :] = 0
        return real(cfg, params, tokens, lengths, *a, **k)

    monkeypatch.setattr(lm_api, "lm_encode_windowed", half)


def _alter_a_symbol(monkeypatch):
    """One decoded symbol altered where the decoder produces it."""
    from lac_tpu_torch.runtime import lm_api

    real = lm_api.lm_decode_windowed

    def altered(*a, **k):
        out = real(*a, **k).clone()
        out[0, 3] = (out[0, 3] + 1) % 256
        return out

    monkeypatch.setattr(lm_api, "lm_decode_windowed", altered)


@pytest.mark.parametrize("fault", [_zero_cache_rows, _half_the_lanes, _alter_a_symbol])
def test_a_broken_timed_path_is_not_correct(tiny, monkeypatch, fault):
    cell = manifest.load_cell("tiny.files", tiny.bench)
    fault(monkeypatch)
    r = runner.run(cell, 9, 0.3, False, "cpu", time.perf_counter())
    assert not r["correct"], r["checks"]


def test_the_control_is_not_correct_at_a_small_size(tiny):
    cell = manifest.load_cell("tiny.files", tiny.bench)
    r = runner.run(cell, 4, 0.3, False, "cpu", time.perf_counter(), control=True)
    assert not r["correct"] and not r["checks"]["gap_mean_bits"]["ok"], r["checks"]
