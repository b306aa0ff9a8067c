"""The share of the profiled encode call's host-clock span in which no
kernel, memcpy or memset runs on the card, in %."""


def read(run):
    if run.view is None:
        return None
    enc = run.view.spans_named("call.encode")[-1]
    return 100.0 * (1.0 - run.view.busy(enc.t0, enc.t1) / enc.seconds)
