"""One run of one cell: set-up, the measured window, the profiled call of a
traced run, the comparison, the metrics and the result line.

Set-up is everything before the window: the program's import, the
weights on the device, the cell's traffic from the seed, and one warm-up
round trip at the cell's shapes. The window is one client in a closed
loop, as a user compressing files one after another: each iteration
encodes one file through the program's file API, decodes the container,
and compares the result with the input; a call ends when its bytes or
ids are on the host. Iterations start until ``seconds`` have passed, and
the one that started inside the window is finished and counted. A traced
run records spans in the window (``spans.py``) and profiles one more
encode call after it (``trace.py``); it reports the per-layer metrics,
an untraced run the end-to-end ones.
"""

from __future__ import annotations

import dataclasses
import os
import sys
import time
import types

import numpy as np
import torch

from . import check, manifest, program, trace
from . import weights as weight_maker
from .spans import Spans

FORBIDDEN = ("jax", "jaxlib", "flax", "lac_tpu")


@dataclasses.dataclass
class Record:
    """What the metric readers read."""

    cell: manifest.Cell
    setup_s: float
    window_s: float
    calls: list                   # per iteration: index, symbols, bytes, enc_s, dec_s, ...
    spans: Spans
    view: trace.TraceView | None  # the profiled encode call (traced runs)


def forbidden_modules() -> list:
    """Loaded modules whose top-level name (before the first dot, whole) is
    JAX's or the JAX package's."""
    return sorted({n for n in sys.modules if n.split(".")[0] in FORBIDDEN})


def cache_dirs(root) -> None:
    """Build and kernel caches at fixed directories inside the checkout."""
    base = root / "benchmark" / "_cache"
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCHINDUCTOR_CACHE_DIR", "inductor"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
        os.environ[var] = str(base / sub)


def _same(out, item) -> bool:
    if isinstance(item, (bytes, bytearray)):
        return out == item
    return np.array_equal(np.asarray(out), np.asarray(item))


def _raw_blocks(container: bytes) -> int:
    _, blocks = check.parse_container(container)
    return sum(1 for b in blocks if b.token_count == 0 and b.raw_len > 0)


def _declare_spans(cell, spans: Spans) -> None:
    for m in cell.per_layer:
        for name, spec in getattr(manifest.reader(cell, "layer_metrics", m["name"]),
                                  "SPANS", {}).items():
            spans.declare(name, spec["target"], spec.get("meta"))


def _mark(what: str, t_start: float) -> None:
    """A set-up stage's end, on standard error (seconds since the start)."""
    print(f"setup: {what} at {time.perf_counter() - t_start:.3f} s", file=sys.stderr)


def run(cell: manifest.Cell, seed: int, seconds: float, traced: bool, device: str,
        t_start: float, control: bool = False) -> dict:
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    family = manifest.family(cell)
    if cuda:
        torch.cuda.init()
    _mark("imports and the device", t_start)
    weights = weight_maker.make(cell, family, seed, dev)
    cfg, params = program.build(cell.model, weights, dev)
    _mark("weights", t_start)
    ctx = types.SimpleNamespace(seed=seed, device=dev, cell=cell, family=family, weights=weights)
    source = manifest.generator(cell).make(cell.traffic, ctx)
    _mark("traffic", t_start)
    host_weights = {k: v.cpu() for k, v in weights.items()}
    del weights, ctx
    compress, decompress = program.api(source.alphabet)
    kw = dict(cell.coding, model=(cfg, params), model_ref=cell.config["model_ref"], device=dev)

    spans = Spans(sync=traced and cuda)
    tap = program.IntervalTap(spans)
    if traced:
        _declare_spans(cell, spans)
    spans.install()
    try:
        if cuda:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        warm = compress(source.item(-1), **kw)
        warm_ok = (_same(decompress(warm, model=(cfg, params), device=dev), source.item(-1))
                   and not _raw_blocks(warm))
        if cuda:
            torch.cuda.synchronize()
        setup_s = time.perf_counter() - t_start
        _mark("warm-up round trip", t_start)

        spans.recording = traced
        calls, containers = [], []
        t0 = time.perf_counter()
        i = 0
        while time.perf_counter() - t0 < seconds:
            item = source.item(i)
            rec = {"index": i, "file": source.key(i), "symbols": source.symbols(item),
                   "bytes": source.nbytes(item)}
            tap.start()
            try:
                with spans.region("call.encode"):
                    a = time.perf_counter()
                    c = compress(item, **kw)
                    rec["enc_s"] = time.perf_counter() - a
                tap.stop()
                with spans.region("call.decode"):
                    a = time.perf_counter()
                    out = decompress(c, model=(cfg, params), device=dev)
                    rec["dec_s"] = time.perf_counter() - a
                rec["container_bytes"] = len(c)
                rec["raw_blocks"] = _raw_blocks(c)
                rec["ok"] = _same(out, item) and rec["raw_blocks"] == 0
            except Exception as e:  # a failed call is counted, and the run goes on
                tap.stop()
                c, rec["ok"], rec["error"] = None, False, f"{type(e).__name__}: {e}"
            calls.append(rec)
            containers.append(c)
            i += 1
        window_s = time.perf_counter() - t0
        for key in ("enc_s", "dec_s"):
            print(f"window: {key} " + " ".join(f"{c[key]:.4f}" for c in calls if key in c),
                  file=sys.stderr)

        view = None
        if traced and cuda:
            spans.phase = "profile"
            got = {}
            with trace.session(got):
                with spans.region("call.encode"):
                    compress(source.item(i), **kw)
            view = got["view"]
        spans.recording = False
    finally:
        spans.restore()

    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    del params, kw
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()

    checks = compare(cell, seed, calls, containers, tap, source, family, host_weights, dev,
                     control, warm_ok)
    record = Record(cell, setup_s, window_s, calls, spans, view)
    kind, metrics = ("layer_metrics", cell.per_layer) if traced else ("end_to_end",
                                                                      cell.end_to_end)
    values = {}
    for m in metrics:
        v = manifest.reader(cell, kind, m["name"]).read(record)
        if v is not None:
            values[m["name"]] = {"value": v, "unit": m["unit"]}
    result = {
        "correct": all(c["ok"] for c in checks.values()),
        "attempted": len(calls),
        "failed": sum(1 for c in calls if not c["ok"]),
        "metrics": values,
        "device": {"platform": "gpu" if cuda else "cpu",
                   "kind": torch.cuda.get_device_name(dev) if cuda else "cpu",
                   "count": 1, "memory_peak_bytes": int(peak)},
    }
    if view is not None:
        enc = view.spans_named("call.encode")[-1]
        result["device"]["busy_s"] = view.busy(enc.t0, enc.t1)
        result["device"]["window_s"] = enc.seconds
        result["breakdown"] = breakdown(view, enc)
    result["checks"] = checks
    return result


def breakdown(view: trace.TraceView, enc) -> dict:
    """The profiled encode call's device operations that took most time, by
    name, and its longest idle stretches, each with the span the host was in."""
    by_name: dict[str, float] = {}
    for o in view.within(view.device, enc.t0, enc.t1):
        by_name[o.name] = by_name.get(o.name, 0.0) + o.seconds
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    gaps = sorted(view.gaps(enc.t0, enc.t1), key=lambda g: -g[1])[:10]
    return {"device_ops": [[n[:160], s] for n, s in ops],
            "idle_gaps": [[view.host_span_at(t + g / 2), g] for t, g in gaps]}


def compare(cell, seed, calls, containers, tap, source, family, host_weights, dev,
            control, warm_ok=True) -> dict:
    """The numbers that decide ``correct``, each beside its limit. The
    warm-up round trip (set-up's) counts among the failed calls too."""
    s = cell.settings
    block, lanes = cell.coding["block_tokens"], cell.coding["lanes"]
    pb = check.prob_bits_for(cell.coding, cell.model["vocab"])
    numbers = {"failed_calls": sum(1 for c in calls if not c["ok"]) + (not warm_ok)}
    ok_calls = [k for k, c in enumerate(calls) if c["ok"]]
    picked = [ok_calls[j] for j in check.sample(len(ok_calls), s["sample_calls"], seed)]
    if picked:
        from reference.common import plain_precision

        plain_precision()
        weights = {k: v.to(dev) for k, v in host_weights.items()}
        rows = s["reference_rows"]
        prog, ref, excess = [], [], []
        for k in picked:
            item = source.item(calls[k]["index"])
            n_blocks = len(check.blocks_of(item, block)[1])
            f_prog = check.tapped_freqs(tap.calls[k], lanes, n_blocks)
            f_ref = check.reference_freqs(family, weights, cell.model, item, block, pb, rows,
                                          dev)
            got_pb, blocks = check.parse_container(containers[k])
            if got_pb != pb:
                raise RuntimeError(f"container prob_bits {got_pb}, the API's rule gives {pb}")
            excess += check.coder_excess(blocks, f_prog, pb)
            if control:
                f_prog = control_freqs(cell, s["control"], item, family, weights, pb, rows, dev)
            prog += f_prog
            ref += f_ref
        numbers.update(gap_mean_bits=float(check.gaps(prog, ref).mean()),
                       extra_bits=check.extra_bits(prog, ref),
                       excess_min_bits=min(excess), excess_max_bits=max(excess))
    for name, value in numbers.items():
        print(f"reading {name}: {value}", file=sys.stderr)
    limits = dict(s["limits"], failed_calls={"max": 0},
                  excess_min_bits={"min": check.EXCESS_MIN_BITS},
                  excess_max_bits={"max": check.EXCESS_MAX_BITS})
    return check.judge(numbers, limits)


def control_freqs(cell, spec, item, family, weights, pb, rows, dev) -> list:
    """The control in the program's place: the program with its own
    lower-precision path on (``kind: program``, ``coding``), or the
    reference computed in lower precision (``kind: reference``,
    ``quant``)."""
    block = cell.coding["block_tokens"]
    if spec["kind"] == "reference":
        return check.reference_freqs(family, weights, cell.model, item, block, pb, rows, dev,
                                     spec["quant"])
    cfg, params = program.build(cell.model, weights, dev)
    compress, _ = program.api("bytes" if isinstance(item, (bytes, bytearray)) else "tokens")
    spans = Spans()
    tap = program.IntervalTap(spans)
    spans.install()
    try:
        tap.start()
        compress(item, **dict(cell.coding, **spec["coding"]), model=(cfg, params),
                 model_ref=cell.config["model_ref"], device=dev)
        tap.stop()
    finally:
        spans.restore()
    n_blocks = len(check.blocks_of(item, block)[1])
    return check.tapped_freqs(tap.calls[0], cell.coding["lanes"], n_blocks)
