"""The share of the encode waves' lane-positions that code nothing
(``runtime/lm_api.py``: a wave runs ``lanes`` lanes of ``block_tokens``
steps whatever the blocks hold): 1 - the live symbols over lanes x
block_tokens, summed over the program's encode ``lac.api.wave`` spans
inside the window's encode calls, in %; 0 where every wave is full."""

from harness import program_trace


def read(run):
    waves = [w["meta"] for w in program_trace.spans(run, "lac.api.wave") or ()
             if w["meta"]["direction"] == "enc"]
    slots = sum(w["lanes"] * w["block_tokens"] for w in waves)
    return 100.0 * (1.0 - sum(w["symbols"] for w in waves) / slots) if slots else None
