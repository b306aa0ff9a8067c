"""The vector rANS coder's share of the encoder (``coder/vector.py``): the
time in the encode scan (``_encode_scan``, as ``runtime/lm_engine.py``
calls it) over the time in ``lm_encode_windowed``, in %."""

from harness import layers

SPANS = {"encode_scan": layers.ENCODE_SCAN, "lm_encode_windowed": layers.ENCODE}


def read(run):
    outer = sum(s.seconds for s in run.spans.of("lm_encode_windowed"))
    scan = sum(s.seconds for s in run.spans.of("encode_scan"))
    return 100.0 * scan / outer if outer else None
