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

``GOLDEN_LM`` is the training slice's golden: the mean causal loss in nats
that ``lac_tpu.train.lm_loss`` (exact attention branch, on the CPU) gives
for the shipped ``checkpoints/byte6l-pysrc.npz`` on ``lm_windows()``, 8
windows of 769 bytes of the first MiB of the corpus.
``tests/test_torch_train.py`` recomputes it with ``lac_tpu``, and
``chip_smoke.py`` holds the port's loss on the card to it, with the fused
attention kernels and with the exact branch.

``GOLDEN_LM_BPB`` is the LM coding slice's golden: the bits per byte
(container bytes x 8 over input bytes) of ``lac_tpu``'s container for the
first ``LM_BPB_BYTES`` (32 KiB) of the corpus, coded on the CPU with the
shipped byte-6l checkpoint at ``LM_CODING`` (the CLI's LM defaults: block
512, 64 lanes, prob_bits 16, cache_grow 128, window mode auto). The
command that produced it, on the CPU, is ``JAX_PLATFORMS=cpu python -c``
with the body of ``tests/test_torch_lm_golden.py``'s test and a print:
``c = lac_tpu.runtime.lm_api.lm_compress_bytes(data, model_ref="file:" +
LM_CHECKPOINT, model=lac_tpu.train.load_checkpoint(LM_CHECKPOINT),
**LM_CODING)`` for ``data = smoke_corpus(LM_BPB_BYTES)``, then
``print(8 * len(c) / len(data))``.

``tests/test_torch_lm_golden.py`` recomputes it with ``lac_tpu``, and
``chip_smoke.py`` holds the port's container on the card to it within 1 %:
float logits differ across stacks, so the port's bits differ a little.
"""

from __future__ import annotations

import glob
import os
import zlib

import numpy as np

__all__ = ["SMOKE_BYTES", "GOLDEN", "GOLDEN_LM", "LM_CHECKPOINT", "GOLDEN_LM_BPB",
           "LM_BPB_BYTES", "LM_CODING", "smoke_corpus", "container_digest", "lm_windows"]

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

# checkpoint name -> lac_tpu's mean loss (nats) on lm_windows()
GOLDEN_LM = {"byte6l-pysrc": 1.636552095413208}
LM_CHECKPOINT = "checkpoints/byte6l-pysrc.npz"
LM_WINDOWS, LM_WINDOW = 8, 769

# lac_tpu's bits/byte for the byte-6l checkpoint's container of the first
# LM_BPB_BYTES of the corpus at LM_CODING
GOLDEN_LM_BPB = 2.13623046875
LM_BPB_BYTES = 32 << 10
LM_CODING = dict(block_tokens=512, lanes=64, prob_bits=16, cache_grow=128,
                 window_mode="auto")

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


def lm_windows(root: str = _REPO) -> np.ndarray:
    """[LM_WINDOWS, LM_WINDOW] int32 token windows of the first MiB of the
    smoke corpus, at starts ``i * ((len - LM_WINDOW) // LM_WINDOWS)``."""
    arr = np.frombuffer(smoke_corpus(1 << 20, root), dtype=np.uint8)
    stride = (len(arr) - LM_WINDOW) // LM_WINDOWS
    return np.stack([arr[i * stride : i * stride + LM_WINDOW]
                     for i in range(LM_WINDOWS)]).astype(np.int32)
