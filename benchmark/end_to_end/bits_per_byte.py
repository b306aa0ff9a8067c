"""8 x the bytes of the containers over the bytes of their inputs, across
the distinct files the window coded (a file the window codes again gives
the same container, and counts once)."""


def read(run):
    seen = {}
    for c in run.calls:
        if "container_bytes" in c:
            seen.setdefault(c["file"], (c["container_bytes"], c["bytes"]))
    if not seen:
        return None
    return 8 * sum(b for b, _ in seen.values()) / sum(n for _, n in seen.values())
