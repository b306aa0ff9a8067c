"""The graph captures' share of the card's idle time: in the profiled
encode call, the device-idle seconds inside the trace's
``span:lac.graph.capture`` annotations over all its device-idle seconds,
in % (a capture records launches and runs none, so the card waits)."""

from harness import program_trace


def read(run):
    if run.view is None or program_trace.TRACER is None:
        return None
    enc = run.view.spans_named("call.encode")[-1]
    caps = [s for s in run.view.spans_named("lac.graph.capture")
            if enc.t0 <= s.t0 and s.t1 <= enc.t1]
    gaps = run.view.gaps(enc.t0, enc.t1)
    idle = sum(g for _, g in gaps)
    inside = sum(max(0.0, min(t + g, c.t1) - max(t, c.t0)) for t, g in gaps for c in caps)
    return 100.0 * inside / idle if idle else None
