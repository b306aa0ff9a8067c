"""The file API's per-call preparation (``runtime/lm_api.py``: the model on
the device, its quantization under w8, the fingerprint's probe step) as a
share of an encode call: the program's ``lac.api.prepare`` spans inside the
window's encode calls over those calls' seconds, in %."""

from harness import program_trace


def read(run):
    return program_trace.share_of_encode_calls(run, "lac.api.prepare")
