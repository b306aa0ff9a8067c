"""The graph captures' share of an encode call (``runtime/step_graph.py``,
``utils/scan.py``): the host seconds of the program's ``lac.graph.capture``
spans inside the window's encode calls over those calls' seconds, in %."""

from harness import program_trace


def read(run):
    return program_trace.share_of_encode_calls(run, "lac.graph.capture")
