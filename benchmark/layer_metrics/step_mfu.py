"""The encode step's model FLOPs over the card's dense bf16 peak for the
time the window's encode steps took (``step_ms.enc``'s spans), in %:
useful FLOPs only (``harness/counts.py``: live lanes, live context)."""

from harness import counts, layers

SPANS = {"steps": layers.STEPS, "lm_encode_windowed": layers.ENCODE}


def read(run):
    seconds = sum(s.seconds for s, _ in layers.steps(run, "enc"))
    flops = layers.sum_over_steps(run, "enc", lambda m, c, t, live: counts.step_flops(m, t, live))
    return 100.0 * flops / (seconds * counts.PEAK_BF16_FLOPS) if seconds else None
