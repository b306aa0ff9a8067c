"""Observability: entropy accounting, throughput counters, profiler hooks,
and the program's own spans and counters.

Ports ``lac_tpu/metrics.py``: ``stream_stats``, ``Throughput``,
``ngram_stats``, ``measure_compress`` (over the port's oracle coder) and
``JsonlLogger`` are copies; ``profile_trace`` (:88-98) records with
``torch.profiler`` where the reference uses ``jax.profiler``.

A fault of torch's profiler (Kineto over CUPTI; seen with torch 2.11 and
CUDA 12.8 on an H100; ``tests/test_torch_gpu.py`` reproduces it): as a
process ages, each session loses the device records of its first few
kernel launches: the launches are recorded, their kernels are not, and the
launches after them keep theirs, whatever their module, with or without a
synchronize or a sleep between. The count grows with the process's CUDA
calls, about one launch for every 5-7 million CUPTI correlation ids
(14-19 at 95 million); graph capture and NCCL do not bring it on, plain
launches do. A trace of a few launches is then blind. ``profile_trace``
therefore opens each session with ``WARM_UP_LAUNCHES`` small launches of
its own (``warm_up``, under a ``record_function`` of that name), which
take the loss, and checks the trace before it writes it
(``checked_trace``): every kernel launch of the region must have its
device event, or it raises and writes nothing. Any other session whose
kernels are read does the same.

Keeps the reference's exact fractional-bit accounting idea
(total_encoded_entropy = emitted + carried info, arith_code.py:220-226;
bits_per_token live counters, arithmetic_coding.py:243-247) vectorized per
stream, and adds what it lacked: the measured-vs-ideal coder-overhead gap as
a regression metric, wall-clock throughput, profiler trace capture, and
structured JSONL logs (SURVEY.md §5 tracing/metrics rows).

Spans and counters (``Tracer``, ``span``, ``count``): the LM coding path
marks its layers (the file API's calls, waves, host packing and container,
the engine's schedule, the step runner's eager steps, graph captures and
replays, the vector coder's encode scan) with ``span(name, **meta)`` and
counts what it did with ``count(name, n)``. With no tracer installed, the
default, each is one ``None`` check: nothing is recorded, no clock is read
and no ``torch`` function is called. ``tracing()`` (or ``set_tracer``)
installs a ``Tracer``, which keeps every record in memory: a span's name,
``t0`` / ``t1`` on ``time.perf_counter``, its ``id``, its ``parent`` (the
enclosing span's id), its ``call`` (the outermost span's id, shared by
every span of one API call) and its ``meta``; a counter's name, time and
increment. A span is also a ``torch.profiler.record_function`` named
``span:<name>``, so that inside a profiler session it annotates the trace
on the trace's own clock, beside the kernels. Spans never synchronize the
device: they time the host, and the profiler's trace is the device's side.
``Tracer.write`` writes the records through ``JsonlLogger``, one line each.
Nothing reads ``Throughput`` on the coding path.
"""

from __future__ import annotations

import contextlib
import json
import os
import sys
import time
from dataclasses import dataclass, field

import numpy as np

__all__ = [
    "stream_stats",
    "Throughput",
    "profile_trace",
    "warm_up",
    "checked_trace",
    "JsonlLogger",
    "ngram_stats",
    "measure_compress",
    "Tracer",
    "set_tracer",
    "tracing",
    "span",
    "count",
]


def stream_stats(freq: np.ndarray, lengths: np.ndarray, payload_bytes: np.ndarray,
                 prob_bits: int) -> dict:
    """Per-stream ideal vs actual coding cost.

    freq: [B, T] the coded symbols' quantized frequencies (0 on padding);
    lengths: [B]; payload_bytes: [B] actual payload sizes. The ideal cost of
    a stream is sum(-log2(freq/2**prob_bits)) over its coded positions; the
    gap to actual is the coder overhead (the reference measured ~0.4% for
    its oracle; rANS should sit well under 0.1% + the 8-byte state flush).
    """
    freq = np.asarray(freq, dtype=np.float64)
    t = freq.shape[1]
    mask = np.arange(t)[None, :] < np.asarray(lengths)[:, None]
    with np.errstate(divide="ignore"):
        bits = np.where(mask, prob_bits - np.log2(np.maximum(freq, 1)), 0.0)
    ideal_bits = bits.sum(axis=1)
    actual_bits = 8.0 * np.asarray(payload_bytes, dtype=np.float64)
    total_ideal = float(ideal_bits.sum())
    total_actual = float(actual_bits.sum())
    return {
        "ideal_bits": ideal_bits,
        "actual_bits": actual_bits,
        "total_ideal_bits": total_ideal,
        "total_actual_bits": total_actual,
        "coder_overhead": (total_actual - total_ideal) / max(total_ideal, 1e-9),
        "bits_per_symbol": total_actual / max(1, int(np.asarray(lengths).sum())),
    }


@dataclass
class Throughput:
    """Wall-clock throughput accumulator (bytes and symbols per second)."""

    name: str = ""
    bytes_done: int = 0
    symbols_done: int = 0
    _t0: float = field(default_factory=time.perf_counter)

    def add(self, nbytes: int = 0, nsymbols: int = 0) -> None:
        self.bytes_done += nbytes
        self.symbols_done += nsymbols

    @property
    def seconds(self) -> float:
        return time.perf_counter() - self._t0

    def report(self) -> dict:
        dt = max(self.seconds, 1e-9)
        return {
            "name": self.name,
            "seconds": round(dt, 4),
            "MB_per_s": round(self.bytes_done / dt / 1e6, 4),
            "symbols_per_s": round(self.symbols_done / dt, 1),
        }


WARM_UP = "profile_trace warm-up"
WARM_UP_LAUNCHES = 1024  # the loss reaches this many at 5e9 CUDA calls or more
_LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
_LAUNCHES = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cudaLaunchCooperativeKernel",
             "cuLaunchKernel", "cuLaunchKernelEx")
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def warm_up(torch) -> None:
    """WARM_UP_LAUNCHES one-element kernels on the card, finished before
    the caller's region starts, under a ``record_function`` named
    ``WARM_UP``: the first launches of a profiler session, whose device
    records it may lose (module docstring); about 5 ms. Call it first
    inside any ``torch.profiler`` session whose kernels are read."""
    with torch.profiler.record_function(WARM_UP):
        x = torch.zeros(1, device="cuda")
        for _ in range(WARM_UP_LAUNCHES):
            x.add_(1)
        torch.cuda.synchronize()


def _check_device_events(path: str) -> list:
    """The events after the warm-up in the Chrome trace at ``path``. Raise,
    and remove ``path``, unless every kernel launch among them has a device
    event of the same correlation id."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    warm_end = max((e["ts"] + e.get("dur", 0) for e in events
                    if e.get("name") == WARM_UP and "ts" in e), default=float("-inf"))
    region = [e for e in events if e.get("ts", 0) > warm_end]
    launches = [e for e in region if e.get("cat") in _LAUNCH_CATS
                and e.get("name") in _LAUNCHES]
    seen = {e.get("args", {}).get("correlation") for e in events
            if e.get("cat") in _DEVICE_CATS}
    blind = [e for e in launches if e.get("args", {}).get("correlation") not in seen]
    if blind:
        os.remove(path)
        raise RuntimeError(
            f"profile_trace: {len(blind)} of {len(launches)} kernel launches have no device "
            f"event (first: {blind[0]['name']}, correlation "
            f"{blind[0].get('args', {}).get('correlation')}); the profiler recorded no kernel "
            "for them, so no trace was written")
    return region


def checked_trace(prof, path: str) -> list:
    """Write the finished CUDA session ``prof`` (opened with ``warm_up``)
    as a Chrome trace at ``path`` and return its events after the warm-up;
    raise, and write nothing, if a kernel launch among them has no device
    event (module docstring). Every session whose kernels are read goes
    through here."""
    prof.export_chrome_trace(path)
    return _check_device_events(path)


@contextlib.contextmanager
def profile_trace(logdir: str):
    """Record the enclosed region with ``torch.profiler`` (the CPU, and the
    card's kernels when CUDA is available) and write it into ``logdir`` as
    a Chrome trace, ``trace.json``, on the way out; yields that path. The
    analog of the reference's debug_log event hook at hardware granularity.
    With CUDA, the session opens with warm-up launches (``WARM_UP``) and
    the trace is written only if every launch of the region has its kernel
    (module docstring); otherwise it raises.
    """
    import torch
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.cuda.is_available()
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    os.makedirs(logdir, exist_ok=True)
    path = os.path.join(logdir, "trace.json")
    with profile(activities=acts) as prof:
        if cuda:
            torch.cuda.synchronize()
            warm_up(torch)
        yield path
        if cuda:
            torch.cuda.synchronize()
    part = path + ".part"
    if cuda:
        checked_trace(prof, part)
    else:
        prof.export_chrome_trace(part)
    os.replace(part, path)


def ngram_stats(data, order: int) -> dict:
    """n-gram frequency counts of a symbol sequence.

    Capability parity with the reference's ``nth_order_stats``
    (arith_code.py:353-361), vectorized: returns {ngram tuple: count} for
    all ``order``-grams. Also reports the empirical conditional entropy an
    order-(n-1) model could reach, which the reference's tool left to the
    caller."""
    seq = np.frombuffer(data, dtype=np.uint8) if isinstance(data, (bytes, bytearray)) \
        else np.asarray(data)
    n = len(seq)
    if order < 1 or n < order:
        return {"counts": {}, "unique": 0, "conditional_entropy_bits": 0.0}
    windows = np.lib.stride_tricks.sliding_window_view(seq, order)
    uniq, counts = np.unique(windows, axis=0, return_counts=True)
    table = {tuple(int(x) for x in row): int(c) for row, c in zip(uniq, counts)}
    # H(X_n | X_1..X_{n-1}) = H(n-gram) - H((n-1)-gram)
    p = counts / counts.sum()
    h_n = float(-(p * np.log2(p)).sum())
    if order > 1:
        w1 = np.lib.stride_tricks.sliding_window_view(seq, order - 1)
        _, c1 = np.unique(w1, axis=0, return_counts=True)
        p1 = c1 / c1.sum()
        h_cond = h_n - float(-(p1 * np.log2(p1)).sum())
    else:
        h_cond = h_n
    return {"counts": table, "unique": len(table), "conditional_entropy_bits": h_cond}


def measure_compress(
    data,
    predictor,
    precision: int = 48,
    report_every: int = 0,
    out=sys.stderr,
) -> tuple[bytes, dict]:
    """Instrumented oracle-coder compression harness.

    Capability parity with the reference's only benchmark runner
    (``measure_compress``, arith_code.py:401-420): codes ``data`` (bytes or
    symbol sequence) with the host arithmetic coder, optionally live-printing
    symbols / total fractional code length / bits-per-symbol every
    ``report_every`` symbols, and returns (payload, stats)."""
    from .coder.reference import ArithmeticEncoder

    syms = list(data) if isinstance(data, (bytes, bytearray)) else list(data)
    enc = ArithmeticEncoder(predictor.copy(), precision)
    t0 = time.perf_counter()
    for i, s in enumerate(syms, 1):
        enc.encode_symbol(s)
        if report_every and i % report_every == 0:
            tot = enc.total_code_length
            print(
                f"{i} symbols -> {tot:.2f} bits, {tot / i:.4f} bits/sym",
                file=out, flush=True,
            )
    payload = enc.flush()
    dt = time.perf_counter() - t0
    stats = {
        "symbols": len(syms),
        "payload_bytes": len(payload),
        "emitted_bits": enc.emitted_bits,
        "bits_per_symbol": 8 * len(payload) / max(1, len(syms)),
        "seconds": dt,
        "symbols_per_s": len(syms) / max(dt, 1e-9),
    }
    return payload, stats


class JsonlLogger:
    """Structured event log (one JSON object per line)."""

    def __init__(self, path: str | None = None):
        self._fh = open(path, "a") if path else sys.stderr

    def log(self, event: str, **fields) -> None:
        rec = {"ts": round(time.time(), 3), "event": event, **fields}
        self._fh.write(json.dumps(rec, sort_keys=True) + "\n")
        self._fh.flush()

    def close(self) -> None:
        """Close the file this logger opened (standard error stays open)."""
        if self._fh is not sys.stderr:
            self._fh.close()


class Tracer:
    """The spans and counters of a traced process, in memory (module
    docstring). ``records``: dicts in the order the spans opened and the
    counts were made, ``kind`` ``"span"`` (``name``, ``t0``, ``t1``, ``id``,
    ``parent``, ``call``, ``meta``) or ``"count"`` (``name``, ``t``, ``n``,
    ``call``); ``totals``: each counter's running sum. Spans nest by the
    order they are entered, so a tracer serves one thread (the coding
    path's)."""

    def __init__(self):
        self.records: list[dict] = []
        self.totals: dict[str, int] = {}
        self._open: list[dict] = []  # the spans entered and not yet left, outermost first
        self._ids = 0

    def spans(self, name: str | None = None) -> list[dict]:
        """The span records, all or those named ``name``."""
        return [r for r in self.records if r["kind"] == "span" and name in (None, r["name"])]

    def count(self, name: str, n: int = 1) -> None:
        self.totals[name] = self.totals.get(name, 0) + n
        self.records.append({"kind": "count", "name": name, "t": time.perf_counter(), "n": n,
                             "call": self._open[0]["id"] if self._open else None})

    def write(self, logger: JsonlLogger) -> None:
        """Every record through ``logger``, one JSON line each (its
        ``event`` is the record's kind)."""
        for r in self.records:
            logger.log(r["kind"], **{k: v for k, v in r.items() if k != "kind"})


class _Span:
    """One span of an installed tracer; ``set`` adds to its meta."""

    __slots__ = ("_tracer", "_rec", "_annotation")

    def __init__(self, tracer: Tracer, name: str, meta: dict):
        self._tracer, self._rec = tracer, {"kind": "span", "name": name, "meta": meta}

    def __enter__(self):
        import torch

        tr, rec = self._tracer, self._rec
        rec["id"], tr._ids = tr._ids, tr._ids + 1
        rec["parent"] = tr._open[-1]["id"] if tr._open else None
        rec["call"] = tr._open[0]["id"] if tr._open else rec["id"]
        tr._open.append(rec)
        tr.records.append(rec)
        self._annotation = torch.profiler.record_function(f"span:{rec['name']}")
        self._annotation.__enter__()
        rec["t0"] = time.perf_counter()
        return self

    def __exit__(self, *exc) -> bool:
        self._rec["t1"] = time.perf_counter()
        self._annotation.__exit__(*exc)
        self._tracer._open.pop()
        return False

    def set(self, **meta) -> None:
        self._rec["meta"].update(meta)


class _NoSpan:
    """The span of a process with no tracer: records nothing. It is false,
    so that a caller can skip computing meta (``if sp: sp.set(...)``)."""

    __slots__ = ()

    def __bool__(self) -> bool:
        return False

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def set(self, **meta) -> None:
        pass


_NO_SPAN = _NoSpan()
_tracer: Tracer | None = None


def set_tracer(tracer: Tracer | None) -> Tracer | None:
    """Install ``tracer`` (None: none) for the process; returns the one it
    replaces."""
    global _tracer
    before, _tracer = _tracer, tracer
    return before


@contextlib.contextmanager
def tracing():
    """Install a fresh ``Tracer`` for the enclosed region and yield it; the
    tracer installed before comes back on the way out."""
    tracer = Tracer()
    before = set_tracer(tracer)
    try:
        yield tracer
    finally:
        set_tracer(before)


def span(name: str, **meta):
    """A context manager that records a span ``name`` with ``meta`` (JSON
    values) in the installed tracer, or does nothing when there is none."""
    tracer = _tracer
    if tracer is None:
        return _NO_SPAN
    return _Span(tracer, name, meta)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` of the installed tracer, if any."""
    tracer = _tracer
    if tracer is not None:
        tracer.count(name, n)
