"""Symbols of all the window's encode calls over the sum of their wall times
(a symbol is a byte, or a token id)."""


def read(run):
    done = [c for c in run.calls if "enc_s" in c]
    return sum(c["symbols"] for c in done) / sum(c["enc_s"] for c in done) if done else None
