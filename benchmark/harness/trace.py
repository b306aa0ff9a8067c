"""One ``torch.profiler`` session over the profiled call of a traced run,
and the view of its Chrome trace that the per-layer readers take.

The session opens with a burst of one-element kernels, finished before
the region starts, and its trace is refused when a kernel launch after the
burst has no device event of its correlation id: late in a long process
the profiler can lose the kernels of a session's first launches. Both are
copies of the program's ``metrics.warm_up`` and ``metrics._check_device_events``,
kept here so that the yardstick does not move with the program.
Times in the view are seconds on the trace's clock.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import tempfile

import torch

WARM_UP = "bench warm-up"
WARM_UP_LAUNCHES = 1024
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
LAUNCHES = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cudaLaunchCooperativeKernel",
            "cuLaunchKernel", "cuLaunchKernelEx")
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def warm_up() -> None:
    with torch.profiler.record_function(WARM_UP):
        x = torch.zeros(1, device="cuda")
        for _ in range(WARM_UP_LAUNCHES):
            x.add_(1)
        torch.cuda.synchronize()


def captures(events: list) -> list:
    """(start, end) of each CUDA graph capture: a launch inside one is
    recorded into the graph, not run, so it has no device event."""
    marks = sorted((e["ts"], "Begin" in e["name"]) for e in events
                   if e.get("cat") in LAUNCH_CATS
                   and str(e.get("name", "")).startswith(("cudaStreamBeginCapture",
                                                          "cudaStreamEndCapture")))
    out, start = [], None
    for ts, begin in marks:
        if begin:
            start = ts
        elif start is not None:
            out.append((start, ts))
            start = None
    return out


def checked_events(events: list) -> list:
    """The events after the warm-up; raise unless every kernel launch among
    them, but those inside a graph capture, has a device event of the same
    correlation id."""
    warm_end = max((e["ts"] + e.get("dur", 0) for e in events
                    if e.get("name") == WARM_UP and "ts" in e), default=float("-inf"))
    region = [e for e in events if e.get("ts", 0) > warm_end]
    held = captures(region)
    launches = [e for e in region if e.get("cat") in LAUNCH_CATS and e.get("name") in LAUNCHES
                and not any(a <= e["ts"] <= b for a, b in held)]
    seen = {e.get("args", {}).get("correlation") for e in events
            if e.get("cat") in DEVICE_CATS}
    blind = [e for e in launches if e.get("args", {}).get("correlation") not in seen]
    if blind:
        raise RuntimeError(f"trace refused: {len(blind)} of {len(launches)} kernel launches "
                           f"have no device event (first: {blind[0]['name']})")
    return region


@dataclasses.dataclass
class Interval:
    name: str
    t0: float
    t1: float
    cat: str = ""

    @property
    def seconds(self) -> float:
        return self.t1 - self.t0


@dataclasses.dataclass
class TraceView:
    device: list      # Interval of every kernel, memcpy and memset, by start
    kernels: list     # the kernels alone
    spans: list       # Interval of every ``span:<name>`` annotation (name without the prefix)

    def spans_named(self, name: str) -> list:
        return [s for s in self.spans if s.name == name]

    def within(self, ops: list, t0: float, t1: float) -> list:
        return [o for o in ops if o.t0 >= t0 and o.t1 <= t1]

    def busy(self, t0: float, t1: float) -> float:
        """Seconds of [t0, t1] in which some device operation runs."""
        total, end = 0.0, t0
        for o in self.device:
            a, b = max(o.t0, end), min(o.t1, t1)
            if b > a:
                total += b - a
                end = b
        return total

    def gaps(self, t0: float, t1: float) -> list:
        """(start, seconds) of each stretch of [t0, t1] with no device op."""
        out, end = [], t0
        for o in self.device:
            if o.t1 <= t0 or o.t0 >= t1:
                continue
            if o.t0 > end:
                out.append((end, o.t0 - end))
            end = max(end, o.t1)
        if t1 > end:
            out.append((end, t1 - end))
        return out

    def host_span_at(self, t: float) -> str:
        """The innermost span the host was in at ``t``."""
        inner = [s for s in self.spans if s.t0 <= t <= s.t1]
        return min(inner, key=lambda s: s.seconds).name if inner else "outside spans"


def view(events: list) -> TraceView:
    """The device operations and the ``span:`` annotations of Chrome trace
    events (``ts`` and ``dur`` in microseconds)."""
    def iv(e, name):
        return Interval(name, e["ts"] * 1e-6, (e["ts"] + e.get("dur", 0)) * 1e-6, e.get("cat"))

    device = sorted((iv(e, e.get("name", "")) for e in events if e.get("cat") in DEVICE_CATS),
                    key=lambda o: o.t0)
    spans = [iv(e, e["name"][5:]) for e in events
             if e.get("cat") == "user_annotation" and str(e.get("name", "")).startswith("span:")]
    return TraceView(device, [o for o in device if o.cat == "kernel"], spans)


@contextlib.contextmanager
def session(out: dict):
    """Profile the enclosed region on the card; on the way out put its
    ``TraceView`` in ``out["view"]``. The Chrome trace goes to a file in
    the temporary directory and is removed once read."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        warm_up()
        yield
        torch.cuda.synchronize()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.remove(path)
    out["view"] = view(checked_events(events))
