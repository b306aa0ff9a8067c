"""CUDA graphs captured an encode call (``runtime/step_graph.py``: one a
cache width; ``utils/scan.py``: the rANS encode scan's chunk): the
program's ``lac.graph.capture`` spans inside the window's encode calls,
over those calls."""

from harness import program_trace


def read(run):
    calls, caps = program_trace.encode_calls(run), program_trace.spans(run, "lac.graph.capture")
    return len(caps) / len(calls) if calls else None
