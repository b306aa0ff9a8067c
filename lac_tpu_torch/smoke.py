"""The smoke corpus and the golden containers it must compress to.

No counterpart in the JAX package. The corpus is the repo's own frozen JAX
package read as bytes: the ``lac_tpu/**/*.py`` files, sorted by their path
relative to the repo root, joined and repeated to length. Those bytes are
the same on every machine, unlike a corpus read from the system's Python
library. The constants are the crc32 and length of the containers that
``lac_tpu``'s native coder (``lac_tpu.native.host.native_compress``, which
is bit-identical to the Pallas path) writes for the 32 MiB corpus;
``tests/test_torch_golden.py`` recomputes them on the CPU, and
``chip_smoke.py`` holds the card's containers to them.
"""

from __future__ import annotations

import glob
import os
import zlib

__all__ = ["SMOKE_BYTES", "GOLDEN", "smoke_corpus", "container_digest"]

SMOKE_BYTES = 32 << 20  # bench.py's corpus size

# (model, block_size) -> (crc32, length) of the container of the 32 MiB corpus
GOLDEN = {
    ("order0n", 4096): (2994531879, 20826341),
    ("order0n", 1024): (1209190892, 21779179),
    ("order1n", 4096): (412144608, 20078619),
    ("order2n", 4096): (1088585412, 19816129),
    ("order1n", 1024): (3498104981, 21408501),
    ("order2n", 1024): (995146321, 21247183),
    ("order0c", 4096): (1802545377, 20686159),
    ("order0c", 1024): (3345983101, 21616345),
    # order0n at block 8192, which its codec gate records as order0c
    ("order0c", 8192): (3279822040, 20531251),
}

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def smoke_corpus(n: int = SMOKE_BYTES, root: str = _REPO) -> bytes:
    """The first ``n`` bytes of the repeated ``lac_tpu/**/*.py`` sources."""
    files = sorted(
        os.path.relpath(p, root)
        for p in glob.glob(os.path.join(root, "lac_tpu", "**", "*.py"), recursive=True)
    )
    if not files:
        raise FileNotFoundError(f"no lac_tpu/**/*.py under {root}")
    parts = []
    for rel in files:
        with open(os.path.join(root, rel), "rb") as f:
            parts.append(f.read())
    data = b"".join(parts)
    return (data * (n // len(data) + 1))[:n]


def container_digest(container: bytes) -> tuple[int, int]:
    return zlib.crc32(container), len(container)
