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

The windowed slice's data is the flagship's held-out slice
(``heldout_slice``): the first 262,144 bytes of every 13th ``.py`` file,
recursive and sorted, of a Python 3.11 standard library
(``bench.heldout_slice()``, which training corpora exclude), committed as
``data/heldout_slice.bin`` because the card's machine runs Python 3.12,
and checked against its crc32. ``GOLDEN_WINDOW_BPB`` holds ``lac_tpu``'s
bits/byte for the byte-6l checkpoint (context 768) on its first
``WINDOW_BPB_BYTES`` (64 KiB) at ``WINDOW_CODING`` (block 2048, 32 lanes,
the CLI's other defaults), once per window mode: 2,048 steps, reprime's
with 4 prefills of 384 tokens. ``GOLDEN_SLIDE16_BPB`` holds its bits/byte
for ``checkpoints/byte16l-pysrc.npz`` on the first ``SLIDE16_BYTES`` at
``SLIDE16_CODING`` (block 4096, 64 lanes, overlap 8, slide:
``measurements/r3_slide.log``'s configuration, 4,096 steps). Each was
computed on the CPU as ``GOLDEN_LM_BPB`` was, with ``lac_tpu``'s
``lm_compress_bytes(data, model_ref="file:" + checkpoint,
model=load_checkpoint(checkpoint), **coding)``; ``tests/test_torch_window.py``
recomputes them (the byte-16l one in a test marked ``slow``), and
``chip_smoke.py``'s phase 5 holds the port's containers on the card to
them within 1 %.

``GOLDEN_Q8_BPB`` holds ``lac_tpu``'s bits/byte for the int8 LM modes:
``GOLDEN_LM_BPB``'s call (byte-6l, the corpus's first ``LM_BPB_BYTES`` at
``LM_CODING``) with ``kv8=True``, ``w8=True`` or both, computed on the CPU
as ``GOLDEN_LM_BPB`` was; ``tests/test_torch_q8_golden.py`` recomputes
them, and ``chip_smoke.py``'s phase 6 holds the port's containers, made
through the CLI's ``--kv8`` / ``--w8``, on the card to them within 1 %.

The det8 slice's goldens. ``GOLDEN_DET8_BPB`` holds ``lac_tpu``'s bits/byte
for ``GOLDEN_LM_BPB``'s call with ``det8=True``, computed on the CPU as
``GOLDEN_LM_BPB`` was. ``GOLDEN_DET8_PORT`` holds the crc32 and length of
the port's own det8 container of the same input, written on the CPU by
``python -m lac_tpu_torch compress FILE --model lm --model-ref
file:checkpoints/byte6l-pysrc.npz --det8 --device cpu`` at ``LM_CODING``
(the CLI's defaults but the model): det8's bits do not depend on the
device, so ``chip_smoke.py``'s phase 7 holds the card's container to it
byte for byte, and its bits/byte to ``GOLDEN_DET8_BPB``. The two share
every block's payload when ``lac_tpu``'s ``det_rsqrt`` is patched to the
documented ``1 / sqrt`` (ROADMAP C); unpatched, every block's words
differ, by the same total bytes. ``GOLDEN_DET8_ROPE`` holds the crc32 of
det8's host RoPE tables (``models.transformer.rope_table``, cos then sin)
of byte-16l (head dim 64, theta 10000) at the rope positions of phase 7's
blocks, 4096 and the flagship's 16384: numpy's float64 ``cos`` and ``sin``
on another machine could move an f32 value, and with it the card's
containers. ``tests/test_torch_det8_golden.py`` recomputes all three.

The scan codecs' goldens. ``GOLDEN_SCAN`` holds the crc32 and length of
``lac_tpu``'s container of the 32 MiB corpus for each scan model at the
CLI's block 4096, and for the API's default (order0, block 65536):
``lac_tpu.runtime.engine.compress_bytes(smoke_corpus(), model_id=model,
block_size=block)`` on the CPU (``JAX_PLATFORMS=cpu``). order0 and order0d
ran as that one call; the three Markov models, whose state is ``[B, 256,
256]`` or ``[B, 256, 257]`` int32 (2 GiB at 8,192 lanes), ran it on each
4 MiB of the corpus in turn, their blocks joined under the whole corpus's
header with ``lac_tpu.stream.container.write_container``: blocks are
independent streams, so the container is the one call's. All six take
about 20 minutes of CPU, most of it markov1's.
``GOLDEN_SCAN_HEAD`` holds ``blocks_digest`` of each golden container's
blocks that cover the corpus's first ``SCAN_HEAD_BYTES`` (256 KiB: 64
blocks of 4096, 4 of 65536). ``tests/test_torch_golden.py`` recomputes
``GOLDEN_SCAN`` in a test marked ``slow``, and in tier-1 holds
``lac_tpu``'s and the port's containers of the first 256 KiB to
``GOLDEN_SCAN_HEAD``; ``chip_smoke.py``'s phase 8 holds the card's
containers to ``GOLDEN_SCAN``.
"""

from __future__ import annotations

import glob
import os
import struct
import zlib

import numpy as np

__all__ = ["SMOKE_BYTES", "GOLDEN", "GOLDEN_LM", "LM_CHECKPOINT", "GOLDEN_LM_BPB",
           "LM_BPB_BYTES", "LM_CODING", "HELDOUT_BYTES", "HELDOUT_CRC", "GOLDEN_WINDOW_BPB",
           "WINDOW_BPB_BYTES", "WINDOW_CODING", "SLIDE16_CHECKPOINT", "GOLDEN_SLIDE16_BPB",
           "SLIDE16_BYTES", "SLIDE16_CODING", "GOLDEN_Q8_BPB", "GOLDEN_DET8_BPB",
           "GOLDEN_DET8_PORT", "GOLDEN_DET8_ROPE", "GOLDEN_SCAN", "GOLDEN_SCAN_HEAD",
           "SCAN_HEAD_BYTES", "smoke_corpus", "container_digest", "blocks_digest",
           "lm_windows", "heldout_slice"]

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

# the held-out slice, as committed
HELDOUT_BYTES = 262144
HELDOUT_CRC = 0x65DB6543

# lac_tpu's bits/byte for the byte-6l checkpoint (LM_CHECKPOINT) on the
# first WINDOW_BPB_BYTES of the held-out slice at WINDOW_CODING, by window mode
GOLDEN_WINDOW_BPB = {"reprime": 1.9459228515625, "slide": 2.996826171875}
WINDOW_BPB_BYTES = 64 << 10
WINDOW_CODING = dict(block_tokens=2048, lanes=32, prob_bits=16, overlap=2, cache_grow=128)

# lac_tpu's bits/byte for byte-16l on the first SLIDE16_BYTES of the
# held-out slice at SLIDE16_CODING
SLIDE16_CHECKPOINT = "checkpoints/byte16l-pysrc.npz"
GOLDEN_SLIDE16_BPB = 0.8763427734375
SLIDE16_BYTES = HELDOUT_BYTES
SLIDE16_CODING = dict(block_tokens=4096, lanes=64, prob_bits=16, overlap=8, cache_grow=128,
                      window_mode="slide")

# lac_tpu's bits/byte for GOLDEN_LM_BPB's call in each int8 mode
GOLDEN_Q8_BPB = {"kv8": 2.14013671875, "w8": 2.13525390625, "kv8+w8": 2.138916015625}

# lac_tpu's bits/byte for GOLDEN_LM_BPB's call with det8, and the (crc32,
# length) of the port's det8 container of it, written on the CPU by the CLI
GOLDEN_DET8_BPB = 2.13623046875
GOLDEN_DET8_PORT = (2799385139, 8750)
# rope positions -> crc32 of byte-16l's det8 RoPE tables (cos, then sin)
GOLDEN_DET8_ROPE = {4096: 3990392779, 16384: 573036838}

# (model, block_size) -> (crc32, length) of lac_tpu's scan container of the
# 32 MiB corpus, and blocks_digest of its blocks over the first
# SCAN_HEAD_BYTES
GOLDEN_SCAN = {
    ("order0", 4096): (1709289346, 21414539),
    ("markov1", 4096): (2323840015, 23478296),
    ("order0d", 4096): (4003335388, 25622716),
    ("markov1d", 4096): (2557422625, 19034685),
    ("markov1c", 4096): (305506078, 18175849),
    ("order0", 65536): (1633755414, 20532112),
}
SCAN_HEAD_BYTES = 256 << 10
GOLDEN_SCAN_HEAD = {
    ("order0", 4096): 2720804872,
    ("markov1", 4096): 3356970471,
    ("order0d", 4096): 4171034829,
    ("markov1d", 4096): 819108436,
    ("markov1c", 4096): 2669889618,
    ("order0", 65536): 1258696629,
}

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_HELDOUT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                        "heldout_slice.bin")


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


def blocks_digest(blocks) -> int:
    """crc32 over each block's raw length and token count (little-endian
    u32) and its payload, in order: the blocks of a container, whatever its
    header."""
    crc = 0
    for b in blocks:
        crc = zlib.crc32(struct.pack("<II", b.raw_len, b.token_count), crc)
        crc = zlib.crc32(b.payload, crc)
    return crc


def lm_windows(root: str = _REPO) -> np.ndarray:
    """[LM_WINDOWS, LM_WINDOW] int32 token windows of the first MiB of the
    smoke corpus, at starts ``i * ((len - LM_WINDOW) // LM_WINDOWS)``."""
    arr = np.frombuffer(smoke_corpus(1 << 20, root), dtype=np.uint8)
    stride = (len(arr) - LM_WINDOW) // LM_WINDOWS
    return np.stack([arr[i * stride : i * stride + LM_WINDOW]
                     for i in range(LM_WINDOWS)]).astype(np.int32)


def heldout_slice() -> bytes:
    """The held-out slice's HELDOUT_BYTES, checked against HELDOUT_CRC."""
    with open(_HELDOUT, "rb") as f:
        data = f.read()
    if len(data) != HELDOUT_BYTES or zlib.crc32(data) != HELDOUT_CRC:
        raise ValueError(f"{_HELDOUT}: {len(data)} bytes, crc32 {zlib.crc32(data):#010x}; "
                         f"want {HELDOUT_BYTES} bytes, crc32 {HELDOUT_CRC:#010x}")
    return data
