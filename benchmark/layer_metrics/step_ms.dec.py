"""The decode step runner's milliseconds a step (``runtime/step_graph.py``,
``SegDecode``): the window's ``steps`` spans over the steps they ran."""

from harness import layers

SPANS = {"steps": layers.STEPS, "lm_decode_windowed": layers.DECODE}


def read(run):
    got = layers.steps(run, "dec")
    n = sum(s.meta["n"] for s, _ in got)
    return 1e3 * sum(s.seconds for s, _ in got) / n if n else None
