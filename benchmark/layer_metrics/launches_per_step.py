"""Device kernels an encode step runs (``models/transformer.py``,
``ops/quantize.py``, ``ops/int8.py``): the kernels inside the profiled
encode call's ``steps`` spans over the steps they ran (a CUDA graph's
memsets are kernels too)."""

from harness import layers

SPANS = {"steps": layers.STEPS, "lm_encode_windowed": layers.ENCODE}


def read(run):
    if run.view is None:
        return None
    got = layers.profiled_steps(run)
    n = sum(s.meta["n"] for _, s, _ in got)
    k = sum(len(run.view.within(run.view.kernels, mk.t0, mk.t1)) for mk, _, _ in got)
    return k / n if n else None
