"""Symbols of all the window's decode calls over the sum of their wall times."""


def read(run):
    done = [c for c in run.calls if "dec_s" in c]
    return sum(c["symbols"] for c in done) / sum(c["dec_s"] for c in done) if done else None
