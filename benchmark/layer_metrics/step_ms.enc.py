"""The encode step runner's milliseconds a step (``runtime/step_graph.py``,
``SegIntervals``): the window's ``steps`` spans over the steps they ran,
the eager first step and the capture at each cache width included."""

from harness import layers

SPANS = {"steps": layers.STEPS, "lm_encode_windowed": layers.ENCODE}


def read(run):
    got = layers.steps(run, "enc")
    n = sum(s.meta["n"] for s, _ in got)
    return 1e3 * sum(s.seconds for s, _ in got) / n if n else None
