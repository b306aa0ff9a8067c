"""Spans recorded from the benchmark's side, around the program's functions.

A target is ``"module:attr.path"``, the name where the caller looks the
function up (a module global, or a class attribute for a method); the
harness replaces it for the run and puts the original back after. On a
target there may be observers, which see every call's arguments (the
comparison's interval tap), and spans, which only a traced run records:
its start and end on the host clock, the ``meta`` that the declaring
reader asks for, and the run's phase (``window``, or ``profile``: the
profiled call after the window). In a traced run each span edge waits for
the device (``torch.cuda.synchronize``), so that a span's time is the
device work it caused, and each span is a ``record_function`` named
``span:<name>``, so that the profiler's trace holds it.
"""

from __future__ import annotations

import contextlib
import dataclasses
import importlib
import time

import torch


@dataclasses.dataclass
class Span:
    name: str
    phase: str
    t0: float
    t1: float
    meta: dict

    @property
    def seconds(self) -> float:
        return self.t1 - self.t0


def _resolve(target: str):
    mod, _, path = target.partition(":")
    owner = importlib.import_module(mod)
    *outer, attr = path.split(".")
    for part in outer:
        owner = getattr(owner, part)
    return owner, attr


class Spans:
    def __init__(self, sync: bool = False):
        self.sync = sync          # wait for the device at each edge (traced runs)
        self.recording = False    # record spans (traced runs)
        self.phase = "window"
        self.records: list[Span] = []
        self._targets: dict[str, dict] = {}
        self._installed: list = []

    def _entry(self, target: str) -> dict:
        return self._targets.setdefault(target, {"observers": [], "spans": []})

    def wrap_target(self, target: str, observer) -> None:
        """Call ``observer(args, kwargs)`` before every call of ``target``."""
        self._entry(target)["observers"].append(observer)

    def declare(self, name: str, target: str, meta=None) -> None:
        """A span ``name`` around every call of ``target``; ``meta(args,
        kwargs) -> dict`` is read once the device has caught up."""
        spans = self._entry(target)["spans"]
        if all(n != name for n, _ in spans):
            spans.append((name, meta))

    def _edge(self) -> float:
        if self.sync:
            torch.cuda.synchronize()
        return time.perf_counter()

    @contextlib.contextmanager
    def region(self, name: str, meta: dict | None = None):
        """A span of the harness's own (a timed call)."""
        if not self.recording:
            yield
            return
        t0 = self._edge()
        with torch.profiler.record_function(f"span:{name}"):
            yield
        self.records.append(Span(name, self.phase, t0, self._edge(), meta or {}))

    def _wrapper(self, original, entry: dict):
        def wrapper(*args, **kwargs):
            for observe in entry["observers"]:
                observe(args, kwargs)
            if not (self.recording and entry["spans"]):
                return original(*args, **kwargs)
            if self.sync:
                torch.cuda.synchronize()
            metas = [(n, meta(args, kwargs) if meta else {}) for n, meta in entry["spans"]]
            t0 = time.perf_counter()
            with contextlib.ExitStack() as stack:
                for n, _ in metas:
                    stack.enter_context(torch.profiler.record_function(f"span:{n}"))
                out = original(*args, **kwargs)
            t1 = self._edge()
            self.records.extend(Span(n, self.phase, t0, t1, m) for n, m in metas)
            return out

        return wrapper

    def install(self) -> None:
        for target, entry in self._targets.items():
            owner, attr = _resolve(target)
            original = owner.__dict__[attr] if isinstance(owner, type) else getattr(owner, attr)
            setattr(owner, attr, self._wrapper(original, entry))
            self._installed.append((owner, attr, original))

    def restore(self) -> None:
        while self._installed:
            owner, attr, original = self._installed.pop()
            setattr(owner, attr, original)

    def of(self, name: str, phase: str = "window") -> list[Span]:
        return [s for s in self.records if s.name == name and s.phase == phase]
