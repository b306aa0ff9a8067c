"""The file API's own share of an encode call (``runtime/lm_api.py``,
``stream/container.py``): 1 - the time in ``lm_encode_windowed`` over the
time of the window's encode calls, in %."""

from harness import layers

SPANS = {"lm_encode_windowed": layers.ENCODE}


def read(run):
    calls = sum(s.seconds for s in run.spans.of("call.encode"))
    inner = sum(s.seconds for s in run.spans.of("lm_encode_windowed"))
    return 100.0 * (1.0 - inner / calls) if calls else None
