"""Seconds from the start of the process to the first timed call: the
program's import, the weights, the traffic and the warm-up round trip."""


def read(run):
    return run.setup_s
