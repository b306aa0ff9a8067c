"""The encode step's share of its roofline, in %: the least time the card
could take for the profiled encode call's steps (``harness/counts.py``:
the larger of their bytes over the HBM rate and their FLOPs over the bf16
rate, step by step) over the device-busy time inside their spans."""

from harness import counts, layers

SPANS = {"steps": layers.STEPS, "lm_encode_windowed": layers.ENCODE}


def read(run):
    if run.view is None:
        return None
    m, coding = run.cell.model, run.cell.coding
    bound = busy = 0.0
    for mk, s, lengths in layers.profiled_steps(run):
        busy += run.view.busy(mk.t0, mk.t1)
        bound += sum(counts.step_bound_s(m, coding, t, live)
                     for t, live in layers.positions(s, lengths))
    return 100.0 * bound / busy if busy else None
